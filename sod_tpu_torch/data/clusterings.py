"""Clustering for pseudo-mask generation (twin of ``sod_tpu/data/clusterings.py``).

Normalized-cut spectral clustering of patch features, on a batch of images
at once (``sod_tpu`` maps one image over the batch with ``vmap``):

* affinity = the cosine similarity of L2-normalised features, negatives
  set to 0, a unit diagonal;
* ``L_sym = I - D^-1/2 A D^-1/2``;
* the k smallest eigenvectors of ``L_sym``: dense ``torch.linalg.eigh`` up
  to ``_EIGH_MAX_N`` = 512 nodes (the oracle), above it 100 iterations of
  ``(2I - L_sym) Q`` each followed by an orthonormalisation, then a
  Rayleigh-Ritz rotation.  Both node counts of the pipeline (784 ViT
  patches, 3136 ResNet res5 nodes, after the x2 upsample) take the
  subspace path; ``SOD_SPECTRAL_EIGH_MAX_N`` moves the crossover;
* the row-normalised embedding clustered by k-means++ (max-min after a
  seeded first pick) and 50 Lloyd steps.

k-means++ and Lloyd's steps see the embedding only through Euclidean
distances between its rows, so the labels do not change under an
orthogonal change of basis of its columns (eigenvector signs, a rotation
inside a degenerate eigenspace, a QR's sign convention).  The subspace
path therefore orthonormalises with CholeskyQR2 (two rounds of Q = Z
chol(Z^T Z)^-1, batched matmuls and m x m factorisations) where ``sod_tpu``
calls Householder QR: the same span, without a batched QR of tall
matrices on the card.  The first k-means++ pick comes from the port's twin
of ``jax.random.randint`` (``utils/jax_prng.py``), so on the dense path the
labels are ``sod_tpu``'s.
"""
from __future__ import annotations

import os
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from sod_tpu_torch.utils import jax_prng

#: full dense eigh up to this node count, subspace iteration above
_EIGH_MAX_N = int(os.environ.get("SOD_SPECTRAL_EIGH_MAX_N", "512"))


def _norm(x: torch.Tensor) -> torch.Tensor:
    """L2 norm over the last axis, keepdim: sqrt(sum(x * x)), the
    arithmetic of ``jnp.linalg.norm``."""
    return torch.sqrt((x * x).sum(-1, keepdim=True))


def _sq_dists(x: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """[B, N, k] squared distances, ``sod_tpu``'s expanded form."""
    return ((x * x).sum(-1, keepdim=True) - (2.0 * x) @ centers.transpose(-1, -2)
            + (centers * centers).sum(-1)[:, None, :])


def _kmeans_pp_init(x: torch.Tensor, k: int, seed: int) -> torch.Tensor:
    """k-means++ seeding of [B, N, D] points: the seeded first pick (the
    same node for every image, as ``sod_tpu``'s key is the same), then
    greedy max-min.  Returns centers [B, k, D]."""
    b, n, _ = x.shape
    first = jax_prng.randint(seed, n)
    centers = [x[:, first]]
    mind = torch.full((b, n), float("inf"), dtype=x.dtype, device=x.device)
    for _ in range(1, k):
        d = ((x - centers[-1][:, None]) ** 2).sum(-1)
        mind = torch.minimum(mind, d)
        nxt = torch.argmax(mind, dim=1)                       # first of ties
        centers.append(torch.gather(x, 1, nxt[:, None, None].expand(-1, 1, x.shape[2]))[:, 0])
    return torch.stack(centers, 1)


def kmeans(x: torch.Tensor, k: int, seed: int = 0, n_iters: int = 50) -> torch.Tensor:
    """Lloyd's algorithm from a k-means++ start; labels [N] of [N, D] points,
    or [B, N] of a batch [B, N, D]."""
    single = x.dim() == 2
    x = (x[None] if single else x).float()
    centers = _kmeans_pp_init(x, k, seed)
    for _ in range(n_iters):
        labels = torch.argmin(_sq_dists(x, centers), dim=-1)
        one_hot = F.one_hot(labels, k).to(x.dtype)             # [B, N, k]
        counts = one_hot.sum(1)                                # [B, k]
        sums = one_hot.transpose(1, 2) @ x                     # [B, k, D]
        centers = torch.where(counts[..., None] > 0,
                              sums / torch.clamp(counts, min=1)[..., None], centers)
    labels = torch.argmin(_sq_dists(x, centers), dim=-1)
    return labels[0] if single else labels


def _build_lsym(features: torch.Tensor) -> torch.Tensor:
    """``L_sym`` [B, N, N] of features [B, N, D], f32, built in place: the
    caller holds one [B, N, N] buffer."""
    f = features.float()
    f = f / torch.clamp(_norm(f), min=1e-12)
    a = f @ f.transpose(1, 2)                                  # cosine affinity
    a.clamp_(min=0.0)
    a.diagonal(dim1=1, dim2=2).fill_(1.0)                      # unit self-affinity
    dis = torch.rsqrt(torch.clamp(a.sum(-1), min=1e-12))       # [B, N]
    a.mul_(dis[:, :, None]).mul_(dis[:, None, :]).neg_()
    a.diagonal(dim1=1, dim2=2).add_(1.0)
    return a


def _orthonormalize(z: torch.Tensor) -> torch.Tensor:
    """Orthonormal columns spanning those of z [B, N, m]: CholeskyQR2."""
    for _ in range(2):
        g = z.transpose(1, 2) @ z
        r, _ = torch.linalg.cholesky_ex(g, upper=True)
        z = torch.linalg.solve_triangular(r, z, upper=True, left=False)
    return z


def spectral_embedding(features: torch.Tensor, kmax: int,
                       n_subspace_iters: int = 100,
                       eigh_max_n: Optional[int] = None) -> torch.Tensor:
    """The ``kmax`` smallest eigenvectors of the normalized Laplacian of
    features [B, N, D]: [B, N, kmax].  Dense ``eigh`` when N <= the
    crossover (``_EIGH_MAX_N`` unless ``eigh_max_n`` is given), else
    subspace iteration on ``2I - L_sym`` (whose largest eigenpairs are
    L_sym's smallest) from ``jax.random.normal(key(0), (N, kmax + 2))``'s
    twin, then Rayleigh-Ritz."""
    l_sym = _build_lsym(features)
    b, n, _ = l_sym.shape
    if n <= (_EIGH_MAX_N if eigh_max_n is None else eigh_max_n):
        _, vecs = torch.linalg.eigh(l_sym)                     # ascending
        return vecs[..., :kmax]
    m = kmax + 2                                               # guard vectors
    q0 = torch.from_numpy(jax_prng.normal(0, (n, m))).to(l_sym.device)
    q = _orthonormalize(q0.expand(b, n, m).contiguous())
    for _ in range(n_subspace_iters):
        q = _orthonormalize(2.0 * q - l_sym @ q)
    t = q.transpose(1, 2) @ (l_sym @ q)
    _, u = torch.linalg.eigh((t + t.transpose(1, 2)) * 0.5)   # ascending
    return (q @ u)[..., :kmax]


def spectral_cluster(features: torch.Tensor, k: int, seed: int = 0,
                     n_kmeans_iters: int = 50) -> torch.Tensor:
    """Normalized-cut spectral clustering of [N, D] (or [B, N, D]) features."""
    return spectral_cluster_multi(features, (k,), seed, n_kmeans_iters)[0]


def spectral_cluster_multi(features: torch.Tensor, ks: Sequence[int], seed: int = 0,
                           n_kmeans_iters: int = 50,
                           eigh_max_n: Optional[int] = None):
    """Labels for every k in ``ks`` from one eigenbasis per image (the
    first max(ks) eigenvectors nest): a tuple of [N] (or [B, N]) labels."""
    single = features.dim() == 2
    f = features[None] if single else features
    emb = spectral_embedding(f, max(ks), eigh_max_n=eigh_max_n)
    outs = []
    for k in ks:
        e = emb[..., :k]
        e = e / torch.clamp(_norm(e), min=1e-12)
        lab = kmeans(e, k, seed=seed, n_iters=n_kmeans_iters)
        outs.append(lab[0] if single else lab)
    return tuple(outs)


class KMeansClustering:
    """The reference's class name; ``use_gpu`` and ``n_samples`` are kept for
    its signature (the device is the features')."""

    def __init__(self, use_gpu: bool = True, n_samples: Optional[int] = None):
        self.use_gpu = use_gpu
        self.n_samples = n_samples

    def __call__(self, features, k: int, seed: int = 0):
        return kmeans(torch.as_tensor(features), k, seed=seed)


class SpectralClustering:
    """The reference's class name; see ``KMeansClustering``."""

    def __init__(self, use_gpu: bool = True, n_samples: Optional[int] = None):
        self.use_gpu = use_gpu
        self.n_samples = n_samples

    def __call__(self, features, k: int, seed: int = 0):
        return spectral_cluster(torch.as_tensor(features), k, seed=seed)
