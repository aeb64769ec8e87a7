"""Int8 (W8A8) pre-norm ViT encoder block as a hand-written CUDA kernel chain.

Port of ``sod_tpu/ops/fused_block_int8.py`` (the Pallas kernel K8 and its
masked variant): the block of ``ops/fused_block.py`` with its four
projections (QKV, attention output, fc1, fc2) as s8 x s8 -> s32 products.

* Weights are quantised once at load, per output channel, from the f32
  weights: ``s = max(max|w[c, :]| / 127, 1e-12)``,
  ``q = clip(round(w / s), -127, 127)`` (``quantize_weight``; one scale per
  row of the (out, in) ``nn.Linear`` weight).
* Activations are quantised per token row right before each product:
  ``s = max(max|h|, 1e-8) / 127``, ``q = clip(round(h / s), -127, 127)``
  (``quant_rows``; round half to even, true divisions).
* ``qdot``: the integer product exactly, then
  ``f32(acc) * row_scale * col_scale`` in that order, then the f32 bias.
* Rounding points (they differ from the bf16 block's): LN1 and LN2 outputs
  and the tanh-GELU hidden stay f32 until they are quantised; LayerNorm
  parameters and biases are f32; qkv, the attention (identical to the bf16
  block's) and the block output are bf16; ``x1 = x + proj`` stays f32.

The kernel is ``sod_tpu_torch/csrc/fused_block_int8.cu``; its header says
how it is laid out on the card.  ``fused_vit_block_int8`` launches it for a
CUDA tensor and raises if the build or the launch fails; it runs the plain
version ``fused_vit_block_int8_reference`` only for a tensor on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Dict, List, Optional, Tuple

import torch

from sod_tpu_torch.ops.fused_attn import attention_plain
from sod_tpu_torch.ops.fused_block import HEAD_DIMS
from sod_tpu_torch.ops.fused_mlp import _gelu_tanh, check_aligned
from sod_tpu_torch.ops.layers import layer_norm

MAX_TOKENS = 1024              # sod_tpu's whole-block routing contract
MAX_DIM = 768                  # ViT-B width (sod_tpu/models/vit.py:323)
MATS = ("qkv", "proj", "fc1", "fc2")
# where each record entry lives in a models.vit.Block's state dict
_LINEARS = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
            "fc2": "mlp.fc2"}

launches = 0                   # kernel-chain launches, one per block call
_launch_lock = threading.Lock()

Record = Dict[str, Dict[str, torch.Tensor]]


# ---------------------------------------------------------------------------
# Quantisation at load time
# ---------------------------------------------------------------------------

def _f127(like: torch.Tensor) -> torch.Tensor:
    """127 as a tensor: torch on the card turns a division by a Python
    scalar into a product with its reciprocal, which is another f32."""
    return torch.full((), 127.0, dtype=torch.float32, device=like.device)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 of an (out, in) weight:
    (q int8 [out, in], s f32 [out]) with w ~ q * s[:, None]."""
    w = w.detach().float()
    s = (w.abs().amax(dim=1) / _f127(w)).clamp_min(1e-12)
    q = torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8)
    return q, s


def quantize_vit_blocks(source, prefix: Optional[str] = None,
                        device=None) -> List[Record]:
    """One record per encoder block from f32 weights: ``norm1`` / ``norm2``
    {weight, bias} f32, and for each of qkv, proj, fc1, fc2 {q int8
    [out, in], s f32 [out], b f32 [out]}.

    :param source: a ``VisionTransformer`` whose blocks hold the f32
        weights, or a state dict (tensors or numpy arrays) that names them
        ``{prefix}{i}.norm1.weight`` ...; quantise before any cast to bf16.
    :param prefix: of the block keys; default ``blocks.`` for a module,
        ``encoder.blocks.`` for a state dict.
    :param device: where the records go (default: where the weights are).
    """
    if isinstance(source, torch.nn.Module):
        state, prefix = source.state_dict(), prefix or "blocks."
    else:
        state, prefix = source, prefix or "encoder.blocks."
    layers = sorted({int(k[len(prefix):].split(".")[0]) for k in state
                     if k.startswith(prefix)})
    if not layers:
        raise ValueError(f"no encoder blocks under {prefix!r}")

    def get(i, name):
        t = torch.as_tensor(state[f"{prefix}{i}.{name}"]).detach()
        if t.dtype != torch.float32:
            raise ValueError(f"{prefix}{i}.{name} is {t.dtype}: quantise from "
                             "the f32 weights, before the compute-dtype cast")
        return t if device is None else t.to(device)

    records = []
    for i in layers:
        rec: Record = {n: {"weight": get(i, f"{n}.weight").clone(),
                           "bias": get(i, f"{n}.bias").clone()}
                       for n in ("norm1", "norm2")}
        for name, where in _LINEARS.items():
            q, s = quantize_weight(get(i, f"{where}.weight"))
            rec[name] = {"q": q.contiguous(), "s": s,
                         "b": get(i, f"{where}.bias").clone()}
        records.append(rec)
    return records


def vit_quantize_int8(vit, device=None):
    """Attach ``vit.blocks_q`` (``quantize_vit_blocks`` of its f32 blocks):
    ``vit_apply(..., fused=True)`` then routes bf16 tokens through the int8
    block wherever the shape fits.  A plain attribute, so a later
    ``vit.to(dtype)`` leaves the int8 codes and f32 scales alone."""
    vit.blocks_q = quantize_vit_blocks(vit, device=device)
    return vit


def _record_tensors(bq: Record) -> List[torch.Tensor]:
    """The 16 tensors of a record in the kernel's order."""
    out = [bq["norm1"]["weight"], bq["norm1"]["bias"]]
    for name in ("qkv", "proj"):
        out += [bq[name]["q"], bq[name]["s"], bq[name]["b"]]
    out += [bq["norm2"]["weight"], bq["norm2"]["bias"]]
    for name in ("fc1", "fc2"):
        out += [bq[name]["q"], bq[name]["s"], bq[name]["b"]]
    return out


# ---------------------------------------------------------------------------
# The quantised arithmetic, plain PyTorch
# ---------------------------------------------------------------------------

def quant_rows(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-row symmetric int8 of f32 rows [..., K]:
    (q int8 [..., K], s f32 [..., 1]) with h ~ q * s."""
    amax = h.abs().amax(dim=-1, keepdim=True)
    s = amax.clamp_min(1e-8) / _f127(h)
    q = torch.round(h / s).clamp(-127, 127).to(torch.int8)
    return q, s


def _int_matmul(q: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """q [M, K] int8 . wq [N, K]^T int8 as exact integers in an f32 tensor
    (f32 of the exact sum, rounded to nearest: |sum| can pass 2^24)."""
    if q.device.type == "cuda" and q.shape[0] > 16 and q.shape[1] % 8 == 0 \
            and wq.shape[0] % 8 == 0:
        return torch._int_mm(q, wq.t()).to(torch.float32)
    # f64 holds every partial sum exactly (|sum| <= 127^2 K << 2^53)
    return torch.matmul(q.double(), wq.double().t()).to(torch.float32)


def _qdot(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor):
    """``qdot`` and the row codes and scales it made: (f32 [..., N], q, s)."""
    q, s = quant_rows(h)
    acc = _int_matmul(q.reshape(-1, q.shape[-1]), wq)
    return acc.reshape(*h.shape[:-1], wq.shape[0]) * s * ws, q, s


def qdot(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """f32 rows [..., K] x int8 weights [N, K] -> f32 [..., N]: rows
    quantised by ``quant_rows``, the product in exact integers, then
    ``f32(acc) * row_scale * col_scale``."""
    return _qdot(h, wq, ws)[0]


def fused_vit_block_int8_reference(x: torch.Tensor, bq: Record, n_heads: int,
                                   n_real: int,
                                   key_mask: Optional[torch.Tensor] = None,
                                   eps: float = 1e-6,
                                   scratch: Optional[dict] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``sod_tpu``'s ``xla_int8_block``),
    with K8's rounding points.

    :param scratch: a dict that receives the intermediates the kernel chain
        keeps too: the int8 codes ``q_qkv, q_proj, q_fc1, q_fc2`` with their
        row scales ``s_*`` [M], and ``qkv``, ``attn``, ``x1``, ``hid``."""
    b, n, d = x.shape
    x0 = x.float()
    keep = {} if scratch is None else scratch

    def dot(name, h):
        out, q, s = _qdot(h, bq[name]["q"], bq[name]["s"])
        keep[f"q_{name}"], keep[f"s_{name}"] = q.reshape(b * n, -1), s.reshape(-1)
        return out

    h = layer_norm(x0, bq["norm1"]["weight"], bq["norm1"]["bias"], eps)
    qkv = (dot("qkv", h) + bq["qkv"]["b"]).to(torch.bfloat16)
    attn = attention_plain(qkv.float(), n_heads, n_real, key_mask)
    x1 = x0 + dot("proj", attn) + bq["proj"]["b"]
    h2 = layer_norm(x1, bq["norm2"]["weight"], bq["norm2"]["bias"], eps)
    hid = _gelu_tanh(dot("fc1", h2) + bq["fc1"]["b"])
    out = (x1 + dot("fc2", hid) + bq["fc2"]["b"]).to(x.dtype)
    keep.update(qkv=qkv, attn=attn.to(torch.bfloat16), x1=x1, hid=hid)
    return out


# ---------------------------------------------------------------------------
# The kernel chain
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _kernels():
    """The C entries of ``csrc/fused_block_int8.cu``, built at first use:
    (the block chain, the row quantiser alone, the QKV product alone)."""
    from sod_tpu_torch.ops._build import load

    lib = load("fused_block_int8")
    block = lib.sod_fused_vit_block_int8
    block.restype = ctypes.c_int
    block.argtypes = ([ctypes.c_void_p] * 28 + [ctypes.c_int] * 6
                      + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    rows = lib.sod_quant_rows_f32
    rows.restype = ctypes.c_int
    rows.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    gemm = lib.sod_qgemm_bias_bf16
    gemm.restype = ctypes.c_int
    gemm.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return block, rows, gemm


def check_int8_block(x: torch.Tensor, bq: Record, n_heads: int, n_real: int,
                     key_mask: Optional[torch.Tensor]) -> None:
    """Raise ``ValueError`` for what the int8 block does not take: tokens
    [B, n_pad, D] contiguous bf16 with n_pad % 128 == 0 and n_pad <= 1024,
    D % 64 == 0 up to 768, head dim 32 / 64 / 128, hidden % 64 == 0,
    0 < n_real <= n_pad, a [B, n_pad] key mask, a record of D's shapes."""
    if x.dim() != 3 or x.dtype != torch.bfloat16:
        raise ValueError(f"x must be [B, n_pad, D] bfloat16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, n, d = x.shape
    if n % 128:
        raise ValueError(f"pad tokens to a multiple of 128, got {n}")
    if n > MAX_TOKENS:
        raise ValueError(f"the int8 whole-block kernel is the <= {MAX_TOKENS}"
                         f"-token path, got {n}")
    if d % 64 or d > MAX_DIM or d % n_heads or d // n_heads not in HEAD_DIMS:
        raise ValueError(f"unsupported width: d={d}, n_heads={n_heads} "
                         f"(need d % 64 == 0, d <= {MAX_DIM}, head dim in "
                         f"{HEAD_DIMS})")
    hidden = bq["fc1"]["q"].shape[0]
    shapes = {"qkv": (3 * d, d), "proj": (d, d), "fc1": (hidden, d),
              "fc2": (d, hidden)}
    if hidden % 64:
        raise ValueError("MLP hidden width must be a multiple of 64")
    for name, shape in shapes.items():
        m = bq[name]
        if (tuple(m["q"].shape) != shape or m["q"].dtype != torch.int8
                or m["s"].dtype != torch.float32 or m["b"].dtype != torch.float32
                or tuple(m["s"].shape) != shape[:1] or tuple(m["b"].shape) != shape[:1]):
            raise ValueError(f"record entry {name!r} does not fit d={d}: int8 "
                             f"{shape} codes with f32 [{shape[0]}] scales and bias")
    if not 0 < n_real <= n:
        raise ValueError(f"n_real={n_real} outside (0, {n}]")
    if key_mask is not None and tuple(key_mask.shape) != (b, n):
        raise ValueError(f"key_mask must be [{b}, {n}], got "
                         f"{tuple(key_mask.shape)}")


def fused_vit_block_int8(x: torch.Tensor, bq: Record, n_heads: int,
                         n_real: int, key_mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-6, scratch: Optional[dict] = None
                         ) -> torch.Tensor:
    """Apply one int8-quantised encoder block to padded tokens x
    [B, n_pad, D] (bf16 in and out).

    :param bq: one block's record of ``quantize_vit_blocks``.
    :param n_real: keys at index >= n_real (padding) are excluded.
    :param key_mask: optional [B, n_pad] bool, False keys excluded too.
    :param scratch: see ``fused_vit_block_int8_reference``.
    """
    check_int8_block(x, bq, n_heads, n_real, key_mask)
    if x.device.type == "cpu":
        return fused_vit_block_int8_reference(x, bq, n_heads, n_real, key_mask,
                                              eps, scratch)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 fused block for device {x.device}")

    b, n, d = x.shape
    m = b * n
    dev = x.device
    weights = [w.to(dev).contiguous() for w in _record_tensors(bq)]
    hidden = bq["fc1"]["q"].shape[0]
    mask = (None if key_mask is None
            else key_mask.to(device=dev, dtype=torch.uint8).contiguous())
    codes = torch.empty(m * (3 * d + hidden), device=dev, dtype=torch.int8)
    widths = (d, d, d, hidden)
    offs = [m * sum(widths[:i]) for i in range(5)]
    q = [codes[offs[i]:offs[i + 1]].view(m, widths[i]) for i in range(4)]
    scales = torch.empty(4, m, device=dev, dtype=torch.float32)
    qkv = torch.empty(b, n, 3 * d, device=dev, dtype=torch.bfloat16)
    attn = torch.empty(b, n, d, device=dev, dtype=torch.bfloat16)
    x1 = torch.empty(b, n, d, device=dev, dtype=torch.float32)
    hid = torch.empty(b, n, hidden, device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    tensors = [x, *weights, mask, *q, scales, qkv, attn, x1, hid, out]
    check_aligned(tensors, "int8 fused block")
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(dev):
        rc = _kernels()[0](*ptrs, b, n, d, n_heads, hidden, n_real, eps,
                           (d // n_heads) ** -0.5,
                           torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_vit_block_int8 launch failed: cudaError {rc}")
    global launches
    with _launch_lock:
        launches += 1
    if scratch is not None:
        for i, name in enumerate(MATS):
            scratch[f"q_{name}"], scratch[f"s_{name}"] = q[i], scales[i]
        scratch.update(qkv=qkv, attn=attn, x1=x1, hid=hid)
    return out


def quant_rows_cuda(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's row-quantise launch alone on f32 rows [M, K] on the card
    (M % 4 == 0): (q int8 [M, K], s f32 [M]); ``quant_rows``'s arithmetic."""
    if h.device.type != "cuda" or h.dtype != torch.float32 or h.dim() != 2 \
            or not h.is_contiguous() or h.shape[0] % 4:
        raise ValueError("quant_rows_cuda takes contiguous f32 [M, K] rows on "
                         "the card, M % 4 == 0")
    q = torch.empty(h.shape, device=h.device, dtype=torch.int8)
    s = torch.empty(h.shape[0], device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        rc = _kernels()[1](h.data_ptr(), q.data_ptr(), s.data_ptr(), *h.shape,
                           torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_rows launch failed: cudaError {rc}")
    return q, s


def qgemm_bias_bf16_cuda(q: torch.Tensor, row_scale: torch.Tensor,
                         wq: torch.Tensor, ws: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The chain's s8 x s8 -> s32 product launch alone, with the QKV
    epilogue: bf16(f32(q . wq^T) * row_scale * ws + bias) for codes
    q [M, K], wq [N, K] on the card (M, N, K % 64 == 0)."""
    (m, k), n = q.shape, wq.shape[0]
    if q.device.type != "cuda" or m % 64 or n % 64 or k % 64 or wq.shape[1] != k:
        raise ValueError("qgemm_bias_bf16_cuda takes int8 [M, K] x [N, K] on "
                         "the card with M, N, K % 64 == 0")
    out = torch.empty(m, n, device=q.device, dtype=torch.bfloat16)
    tensors = [q, row_scale, wq, ws, bias, out]
    check_aligned(tensors, "int8 product")
    with torch.cuda.device(q.device):
        rc = _kernels()[2](*(t.data_ptr() for t in tensors), m, n, k,
                           torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 product launch failed: cudaError {rc}")
    return out
