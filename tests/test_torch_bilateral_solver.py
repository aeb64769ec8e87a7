"""The port's bilateral solver (``sod_tpu_torch.postprocess``) against
``sod_tpu``'s on the CPU, on the same images and masks.

Tolerances:

* the grid (``pixel_to_vertex``, ``neighbors``, ``nvertices``): exact, the
  same NumPy code;
* ``_solve_device`` at the defaults (25 CG iterations, tol 1e-5): within
  1e-4 of ``sod_tpu``'s (f32 sums in another order; measured ~1e-6);
* at ``cg_maxiter=200, cg_tol=1e-10`` against the dense solve of the same
  system: atol 5e-3, rtol 1e-2, as ``tests/test_bilateral_solver.py``;
* the CG's iteration count: equal to jax's ``cg`` on cases that stop early;
* ``bilateral_solver_output``: ``soft`` within 1e-4, ``binary`` equal
  wherever ``sod_tpu``'s soft value is more than 1e-4 from 0.5;
* ``fill_holes_and_select``: equal, on the native and the scipy path;
* ``cli/refine``'s PNGs: within one uint8 level of ``sod_tpu``'s.
"""
import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from sod_tpu.cli import refine as jax_refine
from sod_tpu.postprocess import bilateral_solver as jbs
from sod_tpu_torch import native
from sod_tpu_torch.cli import refine
from sod_tpu_torch.postprocess import bilateral_solver as bs

SOFT_TOL = 1e-4


def _make_image(seed, h=24, w=30):
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 40, np.uint8)
    img[h // 4:3 * h // 4, w // 4:4 * w // 5] = 200        # bright object
    img = img + rng.randint(0, 24, img.shape).astype(np.uint8)
    target = np.zeros((h, w), np.float32)
    target[h // 5:4 * h // 5, w // 5:5 * w // 6] = 1.0
    target = np.clip(target + rng.rand(h, w).astype(np.float32) * 0.4 - 0.2, 0, 1)
    return img, target


def _jax_solve(t, c, idx, nbrs, nv, **kw):
    return np.asarray(jbs._solve_device(jnp.asarray(t), jnp.asarray(c), jnp.asarray(idx),
                                        jnp.asarray(nbrs), nvertices=nv, **kw))


@pytest.mark.parametrize("shape,sigmas", [((24, 30), (8, 8, 8)), ((60, 80), (16, 16, 8)),
                                          ((33, 47), (4, 8, 8))])
def test_grid_arrays_equal_sod_tpus(shape, sigmas):
    img, _ = _make_image(1, *shape)
    ours = bs.BilateralGrid(img, *sigmas)
    theirs = jbs.BilateralGrid(img, *sigmas)
    assert ours.nvertices == theirs.nvertices and ours.dim == theirs.dim == 5
    assert np.array_equal(ours.pixel_to_vertex, theirs.pixel_to_vertex)
    assert np.array_equal(ours.neighbors, theirs.neighbors)
    assert np.array_equal(bs.rgb2yuv(img.astype(np.float64)),
                          jbs.rgb2yuv(img.astype(np.float64)))


@pytest.mark.parametrize("seed,shape", [(0, (24, 30)), (1, (60, 80))])
def test_solve_at_the_defaults_matches_sod_tpus(seed, shape):
    img, target = _make_image(seed, *shape)
    t, c, idx, nbrs, nv = bs.solver_inputs(img, target)
    want = _jax_solve(t, c, idx, nbrs, nv)
    got = bs._solve_device(t, c, idx, nbrs, nvertices=nv, device="cpu")
    assert got.dtype == torch.float32
    assert got.shape == want.shape == (65536,)
    np.testing.assert_allclose(got.numpy(), want, atol=SOFT_TOL, rtol=0)


def test_solve_matches_the_dense_solve():
    """The matrix-free PCG solves the same A y = b as an explicitly built
    dense system (``tests/test_bilateral_solver.py``'s construction)."""
    img, _ = _make_image(0)
    h, w = img.shape[:2]
    target = (img[..., 0] > 100).astype(np.float64)
    conf = np.full((h, w), 0.999)
    lam = 256.0
    grid = bs.BilateralGrid(img, sigma_spatial=8, sigma_luma=8, sigma_chroma=8)
    V, idx = grid.nvertices, grid.pixel_to_vertex
    S = np.zeros((V, h * w))
    S[idx, np.arange(h * w)] = 1.0
    blur = 2 * 5 * np.eye(V)
    for d in range(5):
        for oi in range(2):
            nb = grid.neighbors[d, oi]
            for v in range(V):
                if nb[v] >= 0:
                    blur[v, nb[v]] += 1.0
    m = S @ np.ones(h * w)
    n = np.ones(V)
    for _ in range(10):
        n = np.sqrt(n * m / (blur @ n))
    m_corr = n * (blur @ n)
    A = lam * (np.diag(m_corr) - np.diag(n) @ blur @ np.diag(n)) + np.diag(S @ conf.reshape(-1))
    b = S @ (target.reshape(-1) * conf.reshape(-1))
    expected = np.linalg.solve(A, b)[idx].reshape(h, w)

    got = bs._solve_device(target.astype(np.float32), conf.astype(np.float32), idx,
                           grid.neighbors, nvertices=V, lam=lam, cg_maxiter=200,
                           cg_tol=1e-10, device="cpu").numpy().reshape(h, w)
    np.testing.assert_allclose(got, expected, atol=5e-3, rtol=1e-2)


@pytest.mark.parametrize("tol", [1e-3, 1e-4])
def test_cg_stops_after_as_many_iterations_as_jax(tol):
    """jax's count: the least ``maxiter`` whose result is the one of an
    unbounded run (a run cut before the loop's own stop differs)."""
    img, target = _make_image(0)
    t, c, idx, nbrs, nv = bs.solver_inputs(img, target)
    y, iters = bs._solve_device(t, c, idx, nbrs, nvertices=nv, cg_maxiter=200, cg_tol=tol,
                                device="cpu", return_iters=True)
    k = int(iters)
    assert 0 < k < 25                            # stops early, below the default cap
    free = _jax_solve(t, c, idx, nbrs, nv, cg_maxiter=200, cg_tol=tol)
    assert np.array_equal(_jax_solve(t, c, idx, nbrs, nv, cg_maxiter=k, cg_tol=tol), free)
    assert not np.array_equal(_jax_solve(t, c, idx, nbrs, nv, cg_maxiter=k - 1, cg_tol=tol),
                              free)
    np.testing.assert_allclose(y.numpy(), free, atol=SOFT_TOL, rtol=0)


@pytest.mark.parametrize("seed,shape,sigmas", [(0, (24, 30), (16, 16, 8)),
                                               (2, (70, 90), (16, 16, 8)),
                                               (3, (40, 52), (4, 8, 8))])
def test_output_matches_sod_tpus(seed, shape, sigmas):
    img, target = _make_image(seed, *shape)
    kw = dict(zip(("sigma_spatial", "sigma_luma", "sigma_chroma"), sigmas))
    soft_j, binary_j = jbs.bilateral_solver_output(img, target, **kw)
    soft, binary = bs.bilateral_solver_output(img, target, device="cpu", **kw)
    assert soft.shape == binary.shape == shape and binary.dtype == bool
    np.testing.assert_allclose(soft, soft_j, atol=SOFT_TOL, rtol=0)
    off_band = np.abs(soft_j - 0.5) > SOFT_TOL
    assert np.array_equal(binary[off_band], binary_j[off_band])
    assert binary.any()


@pytest.mark.parametrize("path", ["native", "scipy"])
def test_fill_holes_and_select_equals_sod_tpus(path, monkeypatch):
    if path == "native":
        assert native.available()            # the host library builds here
    else:
        monkeypatch.setattr(native, "available", lambda: False)
    rng = np.random.RandomState(4)
    masks = [rng.rand(40, 50) > t for t in (0.3, 0.5, 0.7)]
    hole = np.zeros((20, 20), bool)
    hole[4:16, 4:16] = True
    hole[8:10, 8:10] = False
    masks += [hole, np.zeros((8, 8), bool), np.ones((8, 8), bool)]
    for m in masks:
        assert np.array_equal(bs.fill_holes_and_select(m), jbs.fill_holes_and_select(m))
    filled = bs.fill_holes_and_select(hole)
    assert filled[9, 9] and filled.sum() == 12 * 12


def test_refine_cli_writes_sod_tpus_pngs(tmp_path, monkeypatch):
    monkeypatch.setattr("sod_tpu.utils.compcache.enable_compilation_cache", lambda: None)
    img, target = _make_image(5, 48, 64)
    Image.fromarray(img).save(tmp_path / "im.png")
    Image.fromarray((target * 255).astype(np.uint8)).save(tmp_path / "mask.png")
    outs = {}
    for name, mod, extra in (("ours", refine, ["--device", "cpu"]), ("theirs", jax_refine, [])):
        soft, binary = tmp_path / f"{name}_soft.png", tmp_path / f"{name}_binary.png"
        mod.main(["--image", str(tmp_path / "im.png"), "--mask", str(tmp_path / "mask.png"),
                  "--out-soft", str(soft), "--out-binary", str(binary), *extra])
        outs[name] = [np.asarray(Image.open(p), np.int32) for p in (soft, binary)]
    (s1, b1), (s2, b2) = outs["ours"], outs["theirs"]
    assert s1.shape == b1.shape == (48, 64)
    assert np.abs(s1 - s2).max() <= 1
    # the binary mask may differ only where the soft one sits at 0.5
    assert ((b1 != b2) & (np.abs(s2 - 127.5) > 1)).sum() == 0
    assert refine.build_argparser().parse_args(["--image", "a", "--mask", "b"]).device == "cuda"
    Image.fromarray(img[:40]).save(tmp_path / "short.png")
    with pytest.raises(SystemExit, match="size mismatch"):
        refine.main(["--image", str(tmp_path / "short.png"), "--mask",
                     str(tmp_path / "mask.png"), "--device", "cpu"])
