"""Fast bilateral solver (Barron & Poole) of the port (twin of
``sod_tpu/postprocess/bilateral_solver.py``).

The same split as ``sod_tpu``:

* the data-dependent bilateral-grid construction (5-D XYLUV coordinate
  hashing -> unique vertices) runs once per image on the host in NumPy,
  giving a pixel->vertex index map and per-dimension neighbour tables
  (``rgb2yuv``, ``BilateralGrid``: ``sod_tpu``'s lines);
* the numeric half (``_solve_device``) runs in torch f32 on an explicit
  device: splat is an ``index_add_``, the [1 0 1] blur a gather of the ten
  neighbour tables, then bistochastization (10 fixed iterations) and the
  Jacobi-preconditioned conjugate-gradient solve (25 iterations, tol 1e-5)
  of ``jax.scipy.sparse.linalg.cg`` over the matrix-free operator
  ``A = lam * (Dm - Dn blur Dn) + diag(splat(w))``.  ``sod_tpu`` compiles it
  as one XLA region; XLA's work is ported as plain PyTorch, with no hand
  kernel;
* the binary post-step (fill holes -> connected components -> keep the
  second-largest region, background being the largest) runs on the host,
  in the port's native library when built, else in ``scipy.ndimage``.

Defaults mirror ``bilateral_solver_output``: confidence 0.999, lam 256,
sigmas (spatial 16, luma 16, chroma 8).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

RGB_TO_YUV = np.array([
    [0.299, 0.587, 0.114],
    [-0.168736, -0.331264, 0.5],
    [0.5, -0.418688, -0.081312]])
YUV_OFFSET = np.array([0, 128.0, 128.0]).reshape(1, 1, -1)
MAX_VAL = 255.0


def rgb2yuv(im: np.ndarray) -> np.ndarray:
    return np.tensordot(im, RGB_TO_YUV, ([2], [1])) + YUV_OFFSET


class BilateralGrid:
    """Host-side grid construction: pixel->vertex map + neighbour tables."""

    def __init__(self, im: np.ndarray, sigma_spatial: int = 32,
                 sigma_luma: int = 8, sigma_chroma: int = 8):
        im_yuv = rgb2yuv(im.astype(np.float64))
        Iy, Ix = np.mgrid[:im.shape[0], :im.shape[1]]
        coords = np.dstack([
            (Ix / sigma_spatial).astype(int),
            (Iy / sigma_spatial).astype(int),
            (im_yuv[..., 0] / sigma_luma).astype(int),
            (im_yuv[..., 1] / sigma_chroma).astype(int),
            (im_yuv[..., 2] / sigma_chroma).astype(int),
        ]).reshape(-1, 5)
        self.npixels, self.dim = coords.shape
        # mixed-radix hash over the ACTUAL per-dim coordinate ranges — the
        # reference's fixed base-255 hash (bilateral_solver.py:55) silently
        # collides once any grid coordinate exceeds 255 (e.g. a >8160px-
        # wide upload at sigma_spatial=32), fusing unrelated vertices
        coords -= coords.min(axis=0)
        # radix = max coord + 2, so the +-1 neighbour probes (digits -1 and
        # max+1) can never alias a real vertex via digit carry/borrow
        extents = coords.max(axis=0).astype(np.int64) + 2
        hash_vec = np.concatenate([[1], np.cumprod(extents[:-1])])
        hashed = coords.astype(np.int64) @ hash_vec
        uniq, uniq_idx, self.pixel_to_vertex = np.unique(
            hashed, return_index=True, return_inverse=True)
        self.nvertices = len(uniq)
        uniq_coords = coords[uniq_idx]

        # neighbour tables: for each dim and offset +-1, the neighbouring
        # vertex index or -1 (ref blur matrices, :72-84)
        nbrs = np.full((self.dim, 2, self.nvertices), -1, np.int64)
        for d in range(self.dim):
            for oi, off in enumerate((-1, 1)):
                shifted = uniq_coords.copy()
                shifted[:, d] += off
                nh = shifted @ hash_vec
                locs = np.searchsorted(uniq, nh)
                locs = np.clip(locs, 0, self.nvertices - 1)
                hit = uniq[locs] == nh
                nbrs[d, oi, hit] = locs[hit]
        self.neighbors = nbrs


def _pcg(A, b: torch.Tensor, x0: torch.Tensor, M, maxiter: int, tol: float):
    """``jax.scipy.sparse.linalg.cg`` as jax 0.9.0 runs it (``_cg_solve``)
    with a preconditioner: ``atol2 = max(tol**2 * b.b, 0)``, iterate while
    ``r.r > atol2`` and ``k < maxiter``, updating ``x, r, z = M(r), gamma,
    beta, p`` in that order.  Returns ``(x, k)``: the solution and the
    iterations taken (a 0-d tensor on ``b``'s device).

    The loop never reads a value back to the host: it runs all ``maxiter``
    iterations and applies each update through ``torch.where`` on a
    "still running" flag, so the solve is one stream of launches with no
    synchronisation (a host test per iteration would stall the device up to
    ``maxiter`` times).  The results equal the early-stopping loop's: once
    the flag drops the state no longer changes, so neither does the test.
    ``where`` and not a product with the flag, because after convergence
    ``alpha`` and ``beta`` can be inf or NaN (``p.Ap`` or ``gamma`` 0)."""
    atol2 = torch.clamp(torch.square(torch.tensor(tol, dtype=b.dtype, device=b.device))
                        * torch.dot(b, b), min=0.0)
    x = x0
    r = b - A(x0)
    p = M(r)
    gamma = torch.dot(r, p)
    k = torch.zeros((), dtype=torch.int64, device=b.device)
    for _ in range(maxiter):
        running = torch.dot(r, r) > atol2
        Ap = A(p)
        alpha = gamma / torch.dot(p, Ap)
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = M(r_)
        gamma_ = torch.dot(r_, z_)
        beta_ = gamma_ / gamma
        p_ = z_ + beta_ * p
        x = torch.where(running, x_, x)
        r = torch.where(running, r_, r)
        gamma = torch.where(running, gamma_, gamma)
        p = torch.where(running, p_, p)
        k = k + running.to(k.dtype)
    return x, k


def _solve_device(target, confidence, pixel_to_vertex, neighbors,
                  nvertices: int, lam: float = 256.0,
                  cg_maxiter: int = 25, cg_tol: float = 1e-5,
                  bs_maxiter: int = 10, device="cpu", return_iters: bool = False):
    """Bistochastize + PCG solve, in f32 on ``device``; ``sod_tpu``'s
    ``_solve_device`` step for step.  Inputs are arrays or tensors:
    ``target`` and ``confidence`` per pixel, ``pixel_to_vertex`` [P] and
    ``neighbors`` [dim, 2, V] (-1: none).  Returns the per-pixel solution,
    a tensor on ``device`` (with the CG's iteration count if
    ``return_iters``).

    The splat's ``index_add_`` sums in no fixed order on a GPU, so the card
    and the CPU differ in f32 rounding: the result is not deterministic
    there, and agrees with ``sod_tpu`` to f32 noise (the tests' bounds)."""
    dev = torch.device(device)
    t = torch.as_tensor(target, dtype=torch.float32, device=dev).reshape(-1)
    c = torch.as_tensor(confidence, dtype=torch.float32, device=dev).reshape(-1)
    idx = torch.as_tensor(pixel_to_vertex, dtype=torch.int64, device=dev)
    nb = torch.as_tensor(neighbors, dtype=torch.int64, device=dev)
    dim = nb.shape[0]
    # the ten tables as one gather into y with a zero appended: a missing
    # neighbour (-1) reads the zero, as sod_tpu's where(nb >= 0, y[nb], 0)
    gather = torch.where(nb >= 0, nb, nvertices).reshape(2 * dim, nvertices)
    zero = torch.zeros(1, dtype=torch.float32, device=dev)

    def splat(x):
        return torch.zeros(nvertices, dtype=torch.float32, device=dev).index_add_(0, idx, x)

    def blur(y):
        out = 2.0 * dim * y
        contrib = torch.cat([y, zero])[gather]
        for j in range(2 * dim):          # sod_tpu's order: d, then -1 / +1
            out = out + contrib[j]
        return out

    # bistochastization (ref :107-118)
    m = splat(torch.ones_like(t))
    n = torch.ones(nvertices, dtype=torch.float32, device=dev)
    for _ in range(bs_maxiter):
        n = torch.sqrt(torch.clamp(n * m / torch.clamp(blur(n), min=1e-20), min=0.0))
    m_corr = n * blur(n)

    w_splat = splat(c)
    b = splat(t * c)
    y0 = b / torch.clamp(w_splat, min=1e-10)

    def A(y):
        smooth = m_corr * y - n * blur(n * y)
        return lam * smooth + w_splat * y

    a_diag = lam * (m_corr - n * n * (2.0 * dim)) + w_splat
    a_diag = torch.clamp(a_diag, min=1e-5)      # A_diag_min (ref :144)

    def precond(y):
        return y / a_diag

    y, iters = _pcg(A, b, y0, precond, maxiter=cg_maxiter, tol=cg_tol)
    return (y[idx], iters) if return_iters else y[idx]


def fill_holes_and_select(binary: np.ndarray) -> np.ndarray:
    """fill holes -> CCL -> second-largest region (ref :184-193).

    Uses the port's C++ native kernels when built; scipy.ndimage
    otherwise — both 4-connectivity, identical results."""
    from sod_tpu_torch import native as _native

    if _native.available():
        filled = _native.fill_holes(binary.astype(np.uint8))
        labeled, nr = _native.label(filled.astype(np.uint8))
    else:
        from scipy import ndimage

        filled = ndimage.binary_fill_holes(binary)
        labeled, nr = ndimage.label(filled)
    counts = np.bincount(labeled.reshape(-1), minlength=nr + 1)
    order = np.argsort(counts)
    if len(order) >= 2:
        return labeled == order[-2]
    return np.ones(binary.shape, bool)


def _bucket(n: int, floor: int) -> int:
    b = floor
    while b < n:
        b *= 2
    return b


def solver_inputs(img, target: np.ndarray, sigma_spatial: int = 16,
                  sigma_luma: int = 16, sigma_chroma: int = 8):
    """The host half: the grid of ``img`` and the padded problem that
    ``sod_tpu`` hands its jitted solve, ``(t, c, idx, nbrs, nv_pad)``.

    Vertex and pixel counts are padded to power-of-two buckets, as in
    ``sod_tpu`` (there, so that XLA compiles once per bucket): padded
    pixels carry zero target and confidence and point at a disconnected
    dummy vertex, so real-vertex results are those of the unpadded
    problem."""
    reference = np.asarray(img)
    h, w = target.shape

    grid = BilateralGrid(reference, sigma_spatial=sigma_spatial,
                         sigma_luma=sigma_luma, sigma_chroma=sigma_chroma)

    nv = grid.nvertices
    nv_pad = _bucket(nv + 1, 512)          # +1: the dummy vertex must exist
    nbrs = np.full((grid.neighbors.shape[0], 2, nv_pad), -1, np.int64)
    nbrs[:, :, :nv] = grid.neighbors

    npix = h * w
    np_pad = _bucket(npix, 1 << 16)
    t = np.zeros(np_pad, np.float32)
    t[:npix] = np.asarray(target, np.float32).reshape(-1)
    c = np.zeros(np_pad, np.float32)
    c[:npix] = 0.999                        # ref confidence (:173)
    idx = np.full(np_pad, nv_pad - 1, np.int64)
    idx[:npix] = grid.pixel_to_vertex
    return t, c, idx, nbrs, nv_pad


def bilateral_solver_output(
    img, target: np.ndarray, sigma_spatial: int = 16, sigma_luma: int = 16,
    sigma_chroma: int = 8, lam: float = 256.0, device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """ref ``bilateral_solver_output`` (:152-193): returns (soft, binary),
    host arrays; the solve runs on ``device``."""
    h, w = target.shape
    t, c, idx, nbrs, nv_pad = solver_inputs(
        img, target, sigma_spatial=sigma_spatial, sigma_luma=sigma_luma,
        sigma_chroma=sigma_chroma)
    soft = _solve_device(t, c, idx, nbrs, nvertices=nv_pad, lam=lam,
                         device=device)[:h * w].cpu().numpy().reshape(h, w)
    binary = fill_holes_and_select(soft > 0.5)
    return soft, binary
