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

The kernel is ``sod_tpu_torch/csrc/fused_block_int8.cu``, five launches a
block: four s8 products (``gemm_s8_kernel`` in ``csrc/vit_block.cuh``, each
with its row quantiser in its prologue) around the attention; its header
says how it is laid out on the card.  ``fused_vit_block_int8`` launches it
for a CUDA tensor and raises if the build or the launch fails; it runs the
plain version ``fused_vit_block_int8_reference`` only for a tensor on the
CPU.  ``qgemm`` runs each of the four products alone (``qgemm_reference``
its plain version), ``s8_plan`` mirrors the tile plan the kernel picks.
"""
from __future__ import annotations

import ctypes
import functools
import threading
import weakref
from typing import Dict, List, Optional, Tuple

import torch

from sod_tpu_torch.ops.fused_attn import attention_plain
from sod_tpu_torch.ops.fused_block import HEAD_DIMS
from sod_tpu_torch.ops.fused_mlp import _gelu_tanh, check_aligned
from sod_tpu_torch.ops.layers import layer_norm

MAX_TOKENS = 1024              # sod_tpu's whole-block routing contract
MAX_DIM = 768                  # ViT-B width (sod_tpu/models/vit.py:323)
MAX_ROW = 1024                 # K of the LN and bf16 products (csrc LN_MAX_DIM)
MATS = ("qkv", "proj", "fc1", "fc2")
# where each record entry lives in a models.vit.Block's state dict
_LINEARS = {"qkv": "attn.qkv", "proj": "attn.proj", "fc1": "mlp.fc1",
            "fc2": "mlp.fc2"}

launches = 0                   # kernel-chain launches, one per block call
form_launches = 0              # qgemm launches (the products alone)
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
        check_record(rec)
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
    return _quant_with_amax(h, h.abs().amax(dim=-1, keepdim=True))


def _quant_with_amax(h: torch.Tensor, amax: torch.Tensor):
    """``quant_rows`` with each row's amax given [..., 1]."""
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


def qdot(h: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor) -> torch.Tensor:
    """f32 rows [..., K] x int8 weights [N, K] -> f32 [..., N]: rows
    quantised by ``quant_rows``, the product in exact integers, then
    ``f32(acc) * row_scale * col_scale``."""
    q, s = quant_rows(h)
    acc = _int_matmul(q.reshape(-1, q.shape[-1]), wq)
    return acc.reshape(*h.shape[:-1], wq.shape[0]) * s * ws


# ---------------------------------------------------------------------------
# The chain's four products, each with its quantiser: plain PyTorch
# ---------------------------------------------------------------------------

# form: (a's dtype, with LayerNorm, res's dtype, out's dtype); the C entry
# sod_qgemm numbers them in this order
S8_FORMS = {"qkv": (torch.bfloat16, True, None, torch.bfloat16),
            "proj": (torch.bfloat16, False, torch.bfloat16, torch.float32),
            "fc1": (torch.float32, True, None, torch.float32),
            "fc2": (torch.float32, False, torch.float32, torch.bfloat16)}
PART_COLS = 64                 # fc1's row maxima of |hidden|: one per 64 columns
# bytes an element of the rows each form's prologue holds whole in a ring
# stage (csrc qpro_row_elem; fc2 streams column chunks: none)
S8_ROW_ELEM = {"qkv": 2, "proj": 2, "fc1": 4, "fc2": 0}


def qgemm_reference(form: str, a: torch.Tensor, wq: torch.Tensor,
                    ws: torch.Tensor, bias: torch.Tensor,
                    ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                    res: Optional[torch.Tensor] = None,
                    part: Optional[torch.Tensor] = None, eps: float = 1e-6,
                    scratch: Optional[dict] = None):
    """Plain version of one of the chain's products on rows a [M, K], with
    K8's rounding points; returns (out [M, N], fc1's row maxima or None):

        qkv   bf16(qdot(LN(a)) + b)          LN with f32 parameters, in f32
        proj  f32((res + qdot(a)) + b)       a bf16, res bf16
        fc1   f32(tanh-GELU(qdot(LN(a)) + b)), and max |out| per 64 columns
              of each row [M, N / 64]
        fc2   bf16((res + qdot(a)) + b)      a f32, res f32; each row's amax
              is the max of ``part`` [M, K / 64] (fc1's maxima)

    :param scratch: a dict that receives the row codes ``q`` [M, K] and
        scales ``s`` [M] the product used."""
    h = a.float()
    if ln is not None:
        h = layer_norm(h, ln[0], ln[1], eps)
    if form == "fc2":
        q, s = _quant_with_amax(h, part.amax(dim=-1, keepdim=True))
    else:
        q, s = quant_rows(h)
    v = _int_matmul(q, wq) * s * ws
    if scratch is not None:
        scratch.update(q=q, s=s.reshape(-1))
    if form == "qkv":
        return (v + bias).to(torch.bfloat16), None
    if form == "proj":
        return res.float() + v + bias, None
    if form == "fc1":
        hid = _gelu_tanh(v + bias)
        return hid, hid.abs().reshape(hid.shape[0], -1, PART_COLS).amax(dim=-1)
    return (res + v + bias).to(torch.bfloat16), None


def fused_vit_block_int8_reference(x: torch.Tensor, bq: Record, n_heads: int,
                                   n_real: int,
                                   key_mask: Optional[torch.Tensor] = None,
                                   eps: float = 1e-6,
                                   scratch: Optional[dict] = None
                                   ) -> torch.Tensor:
    """Plain PyTorch version of the kernel (``sod_tpu``'s ``xla_int8_block``),
    with K8's rounding points: the four products of ``qgemm_reference``
    around the attention.

    :param scratch: a dict that receives the intermediates the kernel chain
        keeps too: the int8 codes ``q_qkv, q_proj, q_fc1, q_fc2`` with their
        row scales ``s_*`` [M], and ``qkv``, ``attn``, ``x1``, ``hid``."""
    b, n, d = x.shape
    keep = {} if scratch is None else scratch

    def product(name, a, **kw):
        sk = {}
        out, part = qgemm_reference(name, a, bq[name]["q"], bq[name]["s"], bq[name]["b"],
                                    eps=eps, scratch=sk, **kw)
        keep[f"q_{name}"], keep[f"s_{name}"] = sk["q"], sk["s"]
        return out, part

    rows = x.reshape(b * n, d)
    qkv, _ = product("qkv", rows, ln=(bq["norm1"]["weight"], bq["norm1"]["bias"]))
    attn = attention_plain(qkv.reshape(b, n, 3 * d).float(), n_heads, n_real,
                           key_mask).to(torch.bfloat16).reshape(b * n, d)
    x1, _ = product("proj", attn, res=rows)
    hid, part = product("fc1", x1, ln=(bq["norm2"]["weight"], bq["norm2"]["bias"]))
    out, _ = product("fc2", hid, res=x1, part=part)
    keep.update(qkv=qkv.reshape(b, n, 3 * d), attn=attn.reshape(b, n, d),
                x1=x1.reshape(b, n, d), hid=hid.reshape(b, n, -1))
    return out.reshape(b, n, d).to(x.dtype)


# ---------------------------------------------------------------------------
# The kernel chain
# ---------------------------------------------------------------------------

# gemm_s8_kernel's configurations (csrc/vit_block.cuh QGEMM_CONFIG):
# (consumer warpgroups of 64 rows, columns of a tile)
S8_CONFIGS = ((2, 128), (1, 128), (1, 64))
SMEM_MAX = 232448              # dynamic shared memory of one block on an H100
SMS = 132                      # SMs of an H100 SXM


def s8_smem(wg: int, bn: int, k: int, stages: int) -> int:
    """Bytes of shared memory of one gemm_s8_kernel block (qgemm_smem): the
    alignment slack, the kept A panel of codes, the W ring, the row scales
    and their reciprocals, the mbarriers."""
    return 1024 + -(-k // 128) * 64 * wg * 128 + stages * bn * 128 + 64 * wg * 8 + 17 * 8


def s8_lg_stages(wg: int, bn: int, k: int) -> int:
    """log2 of the W stages that fit beside the panel (8, 4 or 2), else -1."""
    return next((lg for lg in (3, 2, 1) if s8_smem(wg, bn, k, 1 << lg) <= SMEM_MAX), -1)


def s8_job_rows(elem: int, k: int, bn: int, bmt: int) -> int:
    """Rows of one prologue job (``qpro_job_rows``): the largest power of
    two of whole rows of k elements of ``elem`` bytes that fits a W stage of
    bn 128-byte rows, at most bmt; 0 if no row fits."""
    r = bmt
    while r and r * k * elem > bn * 128:
        r //= 2
    return r


def s8_plan(m: int, n: int, k: int, row_elem: int, sms: int = SMS) -> Tuple[int, int, int]:
    """The plan of an s8 product C[m, n] over k whose prologue holds whole A
    rows of ``row_elem`` bytes an element in a ring stage (``S8_ROW_ELEM``;
    0: none), a mirror of the kernel's ``qgemm_plan``: (an index of
    ``S8_CONFIGS`` or -1 if none fits, column tiles per block, log2 of the
    ring's stages)."""
    p128, p64 = -(-m // 128), -(-m // 64)

    def fits(i):
        wg, bn = S8_CONFIGS[i]
        rows = s8_job_rows(row_elem, k, bn, 64 * wg) if row_elem else 0
        return (n % bn == 0 and s8_lg_stages(wg, bn, k) > 0
                and (row_elem == 0 or rows << s8_lg_stages(wg, bn, k) >= 16 * wg))

    def tiles(n_ct, panels):
        g = min(n_ct, max(1, sms // panels))
        return g, -(-n_ct // g)

    if p128 >= sms // 4 and fits(0):
        g, t = tiles(n // 128, p128)
        if p128 >= sms or (n // 128) % g == 0:
            return 0, t, s8_lg_stages(*S8_CONFIGS[0], k)
    c = 1 if p64 >= sms // 4 and fits(1) else 2
    if not fits(c):
        c = 1                                  # a W stage too small for an A row
    if not fits(c):
        return -1, 1, 0
    return c, tiles(n // S8_CONFIGS[c][1], p64)[1], s8_lg_stages(*S8_CONFIGS[c], k)


@functools.lru_cache(maxsize=None)
def _lib():
    """``csrc/fused_block_int8.cu``'s library with its entries typed, built
    at first use."""
    from sod_tpu_torch.ops._build import load

    lib = load("fused_block_int8")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, args in (("sod_fused_vit_block_int8", [ptr] * 29 + [i32] * 6 + [f32] * 2 + [ptr]),
                       ("sod_qgemm", [i32] + [ptr] * 11 + [i32] * 3 + [f32, ptr]),
                       ("sod_quant_rows_f32", [ptr] * 3 + [i32] * 2 + [ptr]),
                       ("sod_qgemm_bias_bf16", [ptr] * 6 + [i32] * 3 + [ptr])):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = args
    lib.sod_qgemm_plan.restype = None
    lib.sod_qgemm_plan.argtypes = [i32] * 4 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def kernel_plan(m: int, n: int, k: int, row_elem: int) -> Tuple[int, int, int]:
    """The kernel's own plan for C[m, n] over k (``s8_plan`` on the card's
    SMs); needs the built library and the card."""
    out = (ctypes.c_int * 3)()
    _lib().sod_qgemm_plan(m, n, k, row_elem, out)
    return out[0], out[1], out[2]


# id of a record's qkv codes -> (weak references to its 16 tensors, device,
# d, hidden): records checked once, by ``quantize_vit_blocks`` or at their
# first block call; an entry leaves with its tensor
_checked: Dict[int, tuple] = {}


def check_record(bq: Record):
    """Raise ``ValueError`` for a record the kernel chain does not take: int8
    (out, in) codes of consistent widths with f32 scales and biases, f32
    LayerNorm parameters, every tensor on one device and, on the card,
    contiguous and 16-byte aligned.  Returns (device, d, hidden)."""
    ts = _record_tensors(bq)
    d, hidden = bq["qkv"]["q"].shape[1], bq["fc1"]["q"].shape[0]
    shapes = {"qkv": (3 * d, d), "proj": (d, d), "fc1": (hidden, d), "fc2": (d, hidden)}
    for name, shape in shapes.items():
        m = bq[name]
        if (tuple(m["q"].shape) != shape or m["q"].dtype != torch.int8
                or m["s"].dtype != torch.float32 or m["b"].dtype != torch.float32
                or tuple(m["s"].shape) != shape[:1] or tuple(m["b"].shape) != shape[:1]):
            raise ValueError(f"record entry {name!r} does not fit d={d}: int8 "
                             f"{shape} codes with f32 [{shape[0]}] scales and bias")
    for name in ("norm1", "norm2"):
        if any(tuple(bq[name][k].shape) != (d,) or bq[name][k].dtype != torch.float32
               for k in ("weight", "bias")):
            raise ValueError(f"record entry {name!r} must hold f32 [{d}] weight and bias")
    dev = ts[0].device
    if any(t.device != dev for t in ts):
        raise ValueError("a record's tensors must lie on one device")
    if dev.type == "cuda" and any(not t.is_contiguous() or t.data_ptr() % 16 for t in ts):
        raise ValueError("a record's tensors on the card must be contiguous and "
                         "16-byte aligned")
    _checked[id(ts[2])] = ([weakref.ref(t) for t in ts], dev, d, hidden)
    weakref.finalize(ts[2], _checked.pop, id(ts[2]), None)
    return dev, d, hidden


def _record_info(bq: Record):
    """``check_record``'s (device, d, hidden) and the record's tensors: the
    check runs once per record, later calls confirm it holds the same
    tensors."""
    ts = _record_tensors(bq)
    hit = _checked.get(id(ts[2]))
    if hit is None or any(r() is not t for r, t in zip(hit[0], ts)):
        check_record(bq)
        hit = _checked[id(ts[2])]
    return (*hit[1:], ts)


def check_int8_block(x: torch.Tensor, bq: Record, n_heads: int, n_real: int,
                     key_mask: Optional[torch.Tensor]):
    """Raise ``ValueError`` for what the int8 block does not take: tokens
    [B, n_pad, D] contiguous bf16 with n_pad % 128 == 0 and n_pad <= 1024,
    D % 64 == 0 up to 768, head dim 32 / 64 / 128, hidden % 64 == 0,
    0 < n_real <= n_pad, a [B, n_pad] key mask, a record of D's shapes
    (``check_record``, once per record).  Returns the record's tensors."""
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
    dev, d_rec, hidden, ts = _record_info(bq)
    if d_rec != d:
        raise ValueError(f"a record of width {d_rec} for tokens of width {d}")
    if hidden % 64:
        raise ValueError("MLP hidden width must be a multiple of 64")
    if not 0 < n_real <= n:
        raise ValueError(f"n_real={n_real} outside (0, {n}]")
    if key_mask is not None and tuple(key_mask.shape) != (b, n):
        raise ValueError(f"key_mask must be [{b}, {n}], got "
                         f"{tuple(key_mask.shape)}")
    if x.device.type == "cuda" and (dev != x.device or x.data_ptr() % 16):
        raise ValueError(f"the record lies on {dev}, the tokens on {x.device} "
                         "(the tokens must be 16-byte aligned)")
    return ts


def _count() -> None:
    global launches
    with _launch_lock:
        launches += 1


def fused_vit_block_int8(x: torch.Tensor, bq: Record, n_heads: int,
                         n_real: int, key_mask: Optional[torch.Tensor] = None,
                         eps: float = 1e-6, scratch: Optional[dict] = None
                         ) -> torch.Tensor:
    """Apply one int8-quantised encoder block to padded tokens x
    [B, n_pad, D] (bf16 in and out).

    :param bq: one block's record of ``quantize_vit_blocks``.
    :param n_real: keys at index >= n_real (padding) are excluded.
    :param key_mask: optional [B, n_pad] bool, False keys excluded too.
    :param scratch: see ``fused_vit_block_int8_reference``; on the card the
        chain then also writes the codes and row scales.
    """
    ts = check_int8_block(x, bq, n_heads, n_real, key_mask)
    if x.device.type == "cpu":
        return fused_vit_block_int8_reference(x, bq, n_heads, n_real, key_mask,
                                              eps, scratch)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 fused block for device {x.device}")

    b, n, d = x.shape
    m, hidden, dev = b * n, bq["fc1"]["q"].shape[0], x.device
    mask = (None if key_mask is None
            else key_mask.to(device=dev, dtype=torch.uint8).contiguous())
    # one scratch buffer: qkv bf16, attn bf16, x1 f32, hid f32, the hidden's
    # row maxima f32, and (asked for) the four stages' codes and row scales
    sizes = [m * 3 * d * 2, m * d * 2, m * d * 4, m * hidden * 4, m * hidden // PART_COLS * 4]
    if scratch is not None:
        sizes += [m * d, m * d, m * d, m * hidden, 4 * m * 4]
    offs = [0]
    for size in sizes:
        offs.append(offs[-1] + -(-size // 256) * 256)
    buf = torch.empty(offs[-1], device=dev, dtype=torch.uint8)
    out = torch.empty_like(x)
    base = buf.data_ptr()
    ptrs = [base + o for o in offs[:-1]]
    keep = ptrs[5:] if scratch is not None else [None] * 5
    with torch.cuda.device(dev):
        rc = _lib().sod_fused_vit_block_int8(
            x.data_ptr(), *(t.data_ptr() for t in ts),
            None if mask is None else mask.data_ptr(), *keep, *ptrs[:5], out.data_ptr(),
            b, n, d, n_heads, hidden, n_real, eps, (d // n_heads) ** -0.5,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fused_vit_block_int8 launch failed: cudaError {rc}")
    _count()
    if scratch is not None:
        def view(i, dtype, *shape):
            return buf[offs[i]:offs[i] + sizes[i]].view(dtype).view(*shape)

        widths = (d, d, d, hidden)
        scales = view(9, torch.float32, 4, m)
        for i, name in enumerate(MATS):
            scratch[f"q_{name}"] = view(5 + i, torch.int8, m, widths[i])
            scratch[f"s_{name}"] = scales[i]
        scratch.update(qkv=view(0, torch.bfloat16, b, n, 3 * d),
                       attn=view(1, torch.bfloat16, b, n, d),
                       x1=view(2, torch.float32, b, n, d),
                       hid=view(3, torch.float32, b, n, hidden))
    return out


# ---------------------------------------------------------------------------
# The products alone, for timing and checks
# ---------------------------------------------------------------------------

def _check_form(form, a, wq, ws, bias, ln, res, part) -> None:
    """Raise ``ValueError`` for what ``qgemm`` does not take."""
    if form not in S8_FORMS:
        raise ValueError(f"form must be one of {tuple(S8_FORMS)}, got {form!r}")
    a_t, with_ln, res_t, _ = S8_FORMS[form]
    if a.dim() != 2 or wq.dim() != 2:
        raise ValueError("a must be [M, K], wq [N, K]")
    (m, k), (n, kw) = a.shape, wq.shape
    if kw != k or tuple(ws.shape) != (n,) or tuple(bias.shape) != (n,):
        raise ValueError(f"shapes do not chain: a {tuple(a.shape)}, wq "
                         f"{tuple(wq.shape)}, ws {tuple(ws.shape)}, bias {tuple(bias.shape)}")
    if m % 64 or n % 64 or k % 64:
        raise ValueError(f"need M, N, K % 64 == 0, got M={m}, N={n}, K={k}")
    if a.dtype != a_t or wq.dtype != torch.int8 or ws.dtype != torch.float32 \
            or bias.dtype != torch.float32:
        raise ValueError(f"{form}: a must be {a_t}, wq int8, ws and bias float32")
    if (ln is not None) != with_ln or (res is not None) != (res_t is not None) \
            or (part is not None) != (form == "fc2"):
        raise ValueError(f"{form} takes ln: {with_ln}, res: {res_t is not None}, "
                         f"part: {form == 'fc2'}")
    if with_ln and any(t.shape != (k,) or t.dtype != torch.float32 for t in ln):
        raise ValueError(f"LayerNorm weight and bias must be f32 [{k}]")
    if form != "fc2" and k > MAX_ROW:
        raise ValueError(f"{form} takes rows of K <= {MAX_ROW}, got {k}")
    if res is not None and (tuple(res.shape) != (m, n) or res.dtype != res_t):
        raise ValueError(f"res must be {res_t} [{m}, {n}]")
    if part is not None and (tuple(part.shape) != (m, k // PART_COLS)
                             or part.dtype != torch.float32):
        raise ValueError(f"part must be f32 [{m}, {k // PART_COLS}]")
    if s8_plan(m, n, k, S8_ROW_ELEM[form])[0] < 0:
        raise ValueError(f"no tile of the s8 product fits K={k} in shared memory")


def qgemm(form: str, a: torch.Tensor, wq: torch.Tensor, ws: torch.Tensor,
          bias: torch.Tensor, ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
          res: Optional[torch.Tensor] = None, part: Optional[torch.Tensor] = None,
          eps: float = 1e-6, scratch: Optional[dict] = None):
    """One of the chain's four products alone, its row quantiser in its
    prologue, as the chain launches it (``qgemm_reference`` says what each
    form computes); returns (out, fc1's row maxima or None).  The kernel for
    a CUDA tensor, raising if the build or the launch fails; the plain
    version for a tensor on the CPU.

    :param scratch: a dict that receives the codes ``q`` and row scales
        ``s`` of the quantised rows."""
    _check_form(form, a, wq, ws, bias, ln, res, part)
    if a.device.type == "cpu":
        return qgemm_reference(form, a, wq, ws, bias, ln, res, part, eps, scratch)
    if a.device.type != "cuda":
        raise ValueError(f"no s8 product for device {a.device}")
    tensors = [a, *(ln or (None, None)), wq, ws, bias, res, part]
    if any(t is not None and (t.device != a.device or not t.is_contiguous()
                              or t.data_ptr() % 16) for t in tensors):
        raise ValueError("s8 product tensors must be contiguous, 16-byte aligned "
                         "and on a's device")
    (m, k), n = a.shape, wq.shape[0]
    out = torch.empty(m, n, device=a.device, dtype=S8_FORMS[form][3])
    if form == "fc1":                        # the row maxima it writes
        part = tensors[-1] = torch.empty(m, n // PART_COLS, device=a.device,
                                         dtype=torch.float32)
    q = s = None
    if scratch is not None:
        q = torch.empty(m, k, device=a.device, dtype=torch.int8)
        s = torch.empty(m, device=a.device, dtype=torch.float32)
    ptrs = [None if t is None else t.data_ptr() for t in (*tensors, out, q, s)]
    with torch.cuda.device(a.device):
        rc = _lib().sod_qgemm(list(S8_FORMS).index(form), *ptrs, m, n, k, eps,
                              torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"s8 product launch failed: cudaError {rc}")
    global form_launches
    with _launch_lock:
        form_launches += 1
    if scratch is not None:
        scratch.update(q=q, s=s)
    return out, part if form == "fc1" else None


def quant_rows_cuda(h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chain's row quantiser alone on f32 rows [M, K] on the card
    (M % 4 == 0, K % 8 == 0): (q int8 [M, K], s f32 [M]); ``quant_rows``'s
    arithmetic."""
    if h.device.type != "cuda" or h.dtype != torch.float32 or h.dim() != 2 \
            or not h.is_contiguous() or h.shape[0] % 4 or h.shape[1] % 8:
        raise ValueError("quant_rows_cuda takes contiguous f32 [M, K] rows on "
                         "the card, M % 4 == 0, K % 8 == 0")
    q = torch.empty(h.shape, device=h.device, dtype=torch.int8)
    s = torch.empty(h.shape[0], device=h.device, dtype=torch.float32)
    with torch.cuda.device(h.device):
        rc = _lib().sod_quant_rows_f32(h.data_ptr(), q.data_ptr(), s.data_ptr(), *h.shape,
                                       torch.cuda.current_stream(h.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_rows launch failed: cudaError {rc}")
    return q, s


def qgemm_bias_bf16_cuda(q: torch.Tensor, row_scale: torch.Tensor,
                         wq: torch.Tensor, ws: torch.Tensor,
                         bias: torch.Tensor) -> torch.Tensor:
    """The chain's s8 x s8 -> s32 product on given codes, with the QKV
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
        rc = _lib().sod_qgemm_bias_bf16(*(t.data_ptr() for t in tensors), m, n, k,
                                        torch.cuda.current_stream(q.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"int8 product launch failed: cudaError {rc}")
    return out
