"""One forward GEMM of the ViT block kernels, launched alone.

The projections of K1, K3, K4 and K5 are one CUDA routine,
``gemm_kernel`` in ``sod_tpu_torch/csrc/vit_block.cuh`` (its header says
how it is laid out on the card): C = epilogue(A . W^T) with W in torch's
(out, in) layout, bf16 x bf16 with f32 accumulation, optionally with a
LayerNorm of A's rows first.  ``gemm`` runs its four forward forms, as
K1 calls them, through the C entry ``sod_gemm`` of
``csrc/fused_block.cu``:

    epilogue     ln    a      res    out    K1's
    "bias_bf16"  yes   bf16   -      bf16   QKV
    "res_f32"    no    bf16   bf16   f32    proj (x1 = (x0 + v) + b)
    "gelu_bf16"  yes   f32    -      bf16   fc1
    "res_bf16"   no    bf16   f32    bf16   fc2 (out = (x1 + v) + b)

``gemm`` launches the kernel for a CUDA tensor and raises if the build or
the launch fails; it runs the plain version ``gemm_reference`` only for a
tensor on the CPU.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from sod_tpu_torch.ops.layers import layer_norm

# (epilogue, with LayerNorm, a's dtype, res's dtype) -> sod_gemm's form
FORMS = {("bias_bf16", True, torch.bfloat16, None): 0,
         ("res_f32", False, torch.bfloat16, torch.bfloat16): 1,
         ("gelu_bf16", True, torch.float32, None): 2,
         ("res_bf16", False, torch.bfloat16, torch.float32): 3}
EPILOGUES = ("bias_bf16", "res_f32", "gelu_bf16", "res_bf16")
# the kernel's configurations (csrc/vit_block.cuh GEMM_CONFIG): rows x
# columns of a tile, A's row panel kept ("panel") or streamed beside W
CONFIGS = ("panel128x128", "panel64x128", "panel64x64",
           "stream128x128", "stream64x128", "stream64x64")
MAX_LN_DIM = 1024              # a LayerNorm row panel of 64 rows fits shared memory

launches = 0                   # kernel launches
_launch_lock = threading.Lock()


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry ``sod_gemm`` of ``csrc/fused_block.cu``, built at first use."""
    from sod_tpu_torch.ops._build import load

    fn = load("fused_block").sod_gemm
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                   + [ctypes.c_float, ctypes.c_void_p])
    return fn


def plan(ln: bool, m: int, n: int, k: int) -> Tuple[str, int]:
    """The configuration and column tiles per block the kernel picks for a
    shape (needs the built library, not the card)."""
    from sod_tpu_torch.ops._build import load

    fn = load("fused_block").sod_gemm_plan
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 4
    p = fn(int(ln), m, n, k)
    return CONFIGS[p // 1000], p % 1000


def _check(a, w, bias, epilogue, ln, res) -> int:
    """Raise ``ValueError`` for what the kernel does not take; return the
    form."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    if a.dim() != 2 or w.dim() != 2 or bias.dim() != 1:
        raise ValueError("a must be [M, K], w [N, K], bias [N]")
    (m, k), (n, kw) = a.shape, w.shape
    if kw != k or bias.shape[0] != n:
        raise ValueError(f"shapes do not chain: a {tuple(a.shape)}, w "
                         f"{tuple(w.shape)}, bias {tuple(bias.shape)}")
    if m % 64 or n % 64 or k % 32:
        raise ValueError(f"need M % 64 == 0, N % 64 == 0, K % 32 == 0, got "
                         f"M={m}, N={n}, K={k}")
    if ln is not None:
        if k > MAX_LN_DIM:
            raise ValueError(f"LayerNorm forms take K <= {MAX_LN_DIM}, got {k}")
        if any(t.shape != (k,) for t in ln):
            raise ValueError(f"LayerNorm weight and bias must be [{k}]")
    if res is not None and tuple(res.shape) != (m, n):
        raise ValueError(f"res must be [{m}, {n}], got {tuple(res.shape)}")
    key = (epilogue, ln is not None, a.dtype, None if res is None else res.dtype)
    if key not in FORMS:
        raise ValueError(f"no kernel form for {key}; forms: {sorted(FORMS, key=str)}")
    if w.dtype != torch.bfloat16 or bias.dtype != torch.bfloat16:
        raise ValueError("w and bias must be bfloat16")
    return FORMS[key]


def gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, epilogue: str,
         ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
         res: Optional[torch.Tensor] = None, eps: float = 1e-6) -> torch.Tensor:
    """epilogue(A . W^T + bias) with A = bf16(LayerNorm(a)) when ``ln`` =
    (weight, bias) is given, else A = a; the forms in the module docstring.
    The kernel picks its tile for the shape (``plan``)."""
    form = _check(a, w, bias, epilogue, ln, res)
    if a.device.type == "cpu":
        return gemm_reference(a, w, bias, epilogue, ln, res, eps)
    if a.device.type != "cuda":
        raise ValueError(f"no GEMM kernel for device {a.device}")
    tensors = [a, *(ln or (None, None)), w, bias, res]
    if any(t is not None and (t.device != a.device or not t.is_contiguous()
                              or t.data_ptr() % 16) for t in tensors):
        raise ValueError("GEMM tensors must be contiguous, 16-byte aligned and "
                         "on a's device")
    m, k = a.shape
    n = w.shape[0]
    out = torch.empty(m, n, device=a.device,
                      dtype=torch.float32 if epilogue == "res_f32" else torch.bfloat16)
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    with torch.cuda.device(a.device):
        rc = _kernel()(form, *ptrs, out.data_ptr(), m, n, k, eps,
                       torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gemm launch failed: cudaError {rc}")
    global launches
    with _launch_lock:
        launches += 1
    return out


def gemm_reference(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   epilogue: str,
                   ln: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                   res: Optional[torch.Tensor] = None,
                   eps: float = 1e-6) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points, for any
    input dtypes: A = bf16(LayerNorm(f32(a))) (LN parameters as bf16) or
    f32(a); v = A . bf16(W)^T in f32; bias as bf16 added in f32; then
    bias_bf16: bf16(v + b); res_f32: f32((res + v) + b); gelu_bf16:
    bf16(tanh-GELU(v + b)); res_bf16: bf16((res + v) + b)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    bf16 = torch.bfloat16
    x = a.float()
    if ln is not None:
        x = layer_norm(x, ln[0].to(bf16).float(), ln[1].to(bf16).float(),
                       eps).to(bf16).float()
    v = torch.matmul(x, w.to(bf16).float().t())
    b = bias.to(bf16).float()
    if epilogue == "bias_bf16":
        return (v + b).to(bf16)
    if epilogue == "gelu_bf16":
        h = v + b
        return (0.5 * h * (1.0 + torch.tanh(
            0.7978845608028654 * (h + 0.044715 * h ** 3)))).to(bf16)
    out = res.float() + v + b
    return out if epilogue == "res_f32" else out.to(bf16)
