"""The GEMM of the ViT block kernels, launched alone, and the port's bf16
linear on it.

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

and a fifth, with an f32 bias (the others take a bf16 one), for
``ops/layers.py`` ``linear``:

    "f32bias_bf16"  no  bf16   -      bf16   bf16(v + b), b f32

The backward products of K3 and K4 are the same routine in two more
operand layouts, launched alone here as the chains call them (C entries
``sod_gemm_nn`` and ``sod_gemm_tn``), and the chains' LayerNorm backward
(``sod_ln_bwd``):

    entry                         computes                        K3's / K4's
    gemm_nn(a, w, "bf16")         bf16(a . w)                     dattn = g . Wproj
    gemm_nn(a, w, "f32")          a . w (f32)                     dh = dqkv . Wqkv; dh = da . W1
    gemm_nn(a, w, "dgelu", pre)   da = (a . w) * gelu'(pre):      dy . W2 with the GELU gradient
                                  bf16 da, bf16 gelu(pre), the    on the kept bf16 hidden, or on
                                  column sums of the f32 da;      the hidden recomputed in the
                                  pre = (h, w1, b1): f32(h . w1^T  same kernel
                                  + b1), never stored
    gemm_tn(a, b)                 a^T . b (f32), over the rows    dWproj, dWqkv; dW2, dW1
    ln_backward(x, dh, g, ln_w)   dx, dLN scale, dLN bias, sum g  the LayerNorm backward + residual

(``w`` a torch (out, in) weight used untransposed: [K, N].)  Each entry
launches its kernel for a CUDA tensor and raises if the build or the launch
fails; it runs its plain version (``gemm_reference``, ``gemm_nn_reference``,
``gemm_tn_reference``, ``ln_backward_reference``) only for a tensor on the
CPU.

``linear_tc`` is ``ops/layers.py`` ``linear`` with a bias as one autograd
Function of three of these products: y = gemm(x, bf16(W), f32 b,
"f32bias_bf16"); dx = gemm_nn(dy, bf16(W), "bf16"); dW = f32(bf16(gemm_tn(dy,
x))), the backward of ``weight.to(bf16)``; db = the f32 column sums of dy.
It saves the bf16 x and the bf16 weight, never an f32 copy.  ``linear``
sends it the bf16 CUDA calls that ``linear_takes`` accepts.
"""
from __future__ import annotations

import ctypes
import functools
import threading
from typing import Optional, Tuple

import torch

from sod_tpu_torch.ops.fused_mlp import (_gelu_tanh, _gelu_tanh_grad, _ln_pieces,
                                         ln_backward_reference as _ln_bwd_rows)
from sod_tpu_torch.ops.layers import layer_norm

# (epilogue, with LayerNorm, a's dtype, res's dtype) -> sod_gemm's form
FORMS = {("bias_bf16", True, torch.bfloat16, None): 0,
         ("res_f32", False, torch.bfloat16, torch.bfloat16): 1,
         ("gelu_bf16", True, torch.float32, None): 2,
         ("res_bf16", False, torch.bfloat16, torch.float32): 3,
         ("f32bias_bf16", False, torch.bfloat16, None): 4}
EPILOGUES = ("bias_bf16", "res_f32", "gelu_bf16", "res_bf16", "f32bias_bf16")
# the kernel's configurations (csrc/vit_block.cuh GEMM_CONFIG): rows x
# columns of a tile, A's row panel kept ("panel") or streamed beside W
CONFIGS = ("panel128x128", "panel64x128", "panel64x64",
           "stream128x128", "stream64x128", "stream64x64")
MAX_LN_DIM = 1024              # a LayerNorm row panel of 64 rows fits shared memory

NN_EPILOGUES = ("bf16", "f32", "dgelu")
LAYOUTS = ("nt", "nn", "tn")   # gemm_kernel's operand layouts (csrc/vit_block.cuh Layout)

launches = 0                   # gemm kernel launches (the forward forms)
nn_launches = 0                # gemm_nn launches
tn_launches = 0                # gemm_tn launches
ln_bwd_launches = 0            # ln_backward launches
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


@functools.lru_cache(maxsize=None)
def _lib():
    """``csrc/fused_block.cu``'s library with the backward entries typed."""
    from sod_tpu_torch.ops._build import load

    lib = load("fused_block")
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, args in (("sod_gemm_nn", [i32] + [ptr] * 10 + [i32] * 3 + [ptr]),
                       ("sod_gemm_tn", [ptr] * 4 + [i32] * 3 + [ptr]),
                       ("sod_ln_bwd", [ptr] * 4 + [f32] + [ptr] * 3 + [i32] * 2 + [ptr])):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = args
    for name, n in (("sod_gemm_tn_part_floats", 3), ("sod_ln_bwd_part_floats", 2)):
        getattr(lib, name).restype = ctypes.c_longlong
        getattr(lib, name).argtypes = [i32] * n
    lib.sod_gemm_plan.restype = None
    lib.sod_gemm_plan.argtypes = [i32] * 6 + [ctypes.POINTER(ctypes.c_int)]
    return lib


def _launch(dev: torch.device, fn, *args) -> int:
    """``fn(*args, stream)`` with ``dev`` the current device and ``stream``
    the handle of its current stream; returns the entry's cudaError_t.
    Switches device only when ``dev`` is not the current one."""
    current = torch.cuda.current_device()
    idx = current if dev.index is None else dev.index
    if idx == current:
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))
    with torch.cuda.device(idx):
        return fn(*args, torch._C._cuda_getCurrentRawStream(idx))


def plan(ln: bool, m: int, n: int, k: int, layout: str = "nt",
         dgelu: Optional[str] = None) -> Tuple[str, int, int]:
    """The configuration, column tiles per block and rows per split (TN;
    else 0) the kernel picks for C[m, n] over k in ``layout`` (``dgelu``:
    the GELU gradient on a "kept" hidden or a "recomputed" one); needs the
    built library, not the card."""
    out = (ctypes.c_int * 3)()
    kind = {None: 0, "kept": 1, "recomputed": 2}[dgelu]
    _lib().sod_gemm_plan(LAYOUTS.index(layout), int(ln), m, n, k, kind, out)
    return CONFIGS[out[0]], out[1], out[2]


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
    bias_dtype = torch.float32 if epilogue == "f32bias_bf16" else torch.bfloat16
    if w.dtype != torch.bfloat16 or bias.dtype != bias_dtype:
        raise ValueError(f"w must be bfloat16 and bias {bias_dtype} for {epilogue!r}")
    return FORMS[key]


def tc_shape(m: int, n: int, k: int) -> bool:
    """Whether a linear of [m, k] rows by an (n, k) weight is a shape that
    ``gemm_kernel`` takes in all three of ``linear_tc``'s products: the
    forward [m, k] . [n, k]^T (``_check``: m, n % 64, k % 32), dx = [m, n] .
    [n, k] (``_check_nn``: m, k % 64, n % 32) and dW = [m, n]^T . [m, k]
    (``gemm_tn``: all three % 64)."""
    return m > 0 and m % 64 == 0 and n % 64 == 0 and k % 64 == 0


def linear_takes(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> bool:
    """Whether ``linear_tc`` takes ``linear(x, weight, bias)`` for bf16 x
    [..., K]: a bias, a shape ``tc_shape`` accepts, and x one contiguous,
    16-byte aligned [M, K] matrix (the kernels' layout, ``_on_card``)."""
    k = x.shape[-1]
    return (bias is not None and k > 0 and tc_shape(x.numel() // k, weight.shape[0], k)
            and x.is_contiguous() and x.data_ptr() % 16 == 0)


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
    rc = _launch(a.device, _kernel(), form, *ptrs, out.data_ptr(), m, n, k, eps)
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
    f32(a); v = A . bf16(W)^T in f32; bias as bf16 added in f32 (f32bias_bf16:
    f32(bias), unrounded); then bias_bf16 and f32bias_bf16: bf16(v + b);
    res_f32: f32((res + v) + b); gelu_bf16: bf16(tanh-GELU(v + b));
    res_bf16: bf16((res + v) + b)."""
    if epilogue not in EPILOGUES:
        raise ValueError(f"epilogue must be one of {EPILOGUES}, got {epilogue!r}")
    bf16 = torch.bfloat16
    x = a.float()
    if ln is not None:
        x = layer_norm(x, ln[0].to(bf16).float(), ln[1].to(bf16).float(),
                       eps).to(bf16).float()
    v = torch.matmul(x, w.to(bf16).float().t())
    b = bias.float() if epilogue == "f32bias_bf16" else bias.to(bf16).float()
    if epilogue in ("bias_bf16", "f32bias_bf16"):
        return (v + b).to(bf16)
    if epilogue == "gelu_bf16":
        h = v + b
        return (0.5 * h * (1.0 + torch.tanh(
            0.7978845608028654 * (h + 0.044715 * h ** 3)))).to(bf16)
    out = res.float() + v + b
    return out if epilogue == "res_f32" else out.to(bf16)


# ---------------------------------------------------------------------------
# The backward products and the LayerNorm backward
# ---------------------------------------------------------------------------

def _count(kind: str) -> None:
    global nn_launches, tn_launches, ln_bwd_launches
    with _launch_lock:
        if kind == "nn":
            nn_launches += 1
        elif kind == "tn":
            tn_launches += 1
        else:
            ln_bwd_launches += 1


def _on_card(tensors, what: str) -> bool:
    """False for tensors on the CPU (the plain version runs); True for
    contiguous, 16-byte aligned CUDA tensors on one device; else raises."""
    dev = tensors[0].device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no {what} kernel for device {dev}")
    if any(t.device != dev or not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{what} tensors must be contiguous, 16-byte aligned and on one device")
    return True


def _check_nn(a, w, epilogue, pre) -> None:
    if epilogue not in NN_EPILOGUES:
        raise ValueError(f"epilogue must be one of {NN_EPILOGUES}, got {epilogue!r}")
    if a.dim() != 2 or w.dim() != 2:
        raise ValueError("a must be [M, K], w [K, N]")
    (m, k), (kw, n) = a.shape, w.shape
    if kw != k:
        raise ValueError(f"shapes do not chain: a {tuple(a.shape)}, w {tuple(w.shape)}")
    if m % 64 or n % 64 or k % 32:
        raise ValueError(f"need M % 64 == 0, N % 64 == 0, K % 32 == 0, got M={m}, N={n}, K={k}")
    if a.dtype != torch.bfloat16 or w.dtype != torch.bfloat16:
        raise ValueError("a and w must be bfloat16")
    if (pre is None) != (epilogue != "dgelu"):
        raise ValueError("pre (the pre-GELU hidden) goes with the dgelu epilogue, and only there")
    if isinstance(pre, tuple):
        if len(pre) != 3:
            raise ValueError("pre to recompute is (h, w1, b1)")
        h, w1, b1 = pre
        if (tuple(h.shape), tuple(w1.shape), tuple(b1.shape)) != ((m, k), (n, k), (n,)) \
                or any(t.dtype != torch.bfloat16 for t in pre):
            raise ValueError(f"pre to recompute must be bf16 h [{m}, {k}], w1 [{n}, {k}], "
                             f"b1 [{n}]")
    elif pre is not None and (tuple(pre.shape) != (m, n) or pre.dtype != torch.bfloat16):
        raise ValueError(f"pre must be the kept bf16 hidden [{m}, {n}], got "
                         f"{tuple(pre.shape)} {pre.dtype}")


def gemm_nn(a: torch.Tensor, w: torch.Tensor, epilogue: str, pre=None):
    """a [M, K] . w [K, N] (w a torch (out, in) weight used untransposed),
    bf16 x bf16 in f32: "bf16" -> bf16, "f32" -> f32, "dgelu" -> (bf16 da,
    bf16 gelu(hidden), f32 [N] column sums of the f32 da) with da = (a . w)
    * gelu'(hidden); ``pre`` the kept bf16 hidden [M, N], or (h, w1, b1) to
    recompute it in the same kernel as f32(h . w1^T + b1) (h [M, K], w1
    [N, K], b1 [N], bf16)."""
    _check_nn(a, w, epilogue, pre)
    extra = list(pre) if isinstance(pre, tuple) else [pre] if pre is not None else []
    if not _on_card([a, w, *extra], "gemm_nn"):
        return gemm_nn_reference(a, w, epilogue, pre)
    (m, k), n = a.shape, w.shape[1]
    dev = a.device
    bf16, f32 = torch.bfloat16, torch.float32
    out = torch.empty(m, n, device=dev, dtype=f32 if epilogue == "f32" else bf16)
    out2 = part = colsum = None
    kept, (h, w1, b1) = (None, pre) if isinstance(pre, tuple) else (pre, (None,) * 3)
    form = NN_EPILOGUES.index(epilogue) + (kept is None and epilogue == "dgelu")
    if epilogue == "dgelu":
        out2 = torch.empty_like(out)
        part = torch.empty(m // 64, n, device=dev, dtype=f32)
        colsum = torch.empty(n, device=dev, dtype=f32)
    ptrs = [None if t is None else t.data_ptr()
            for t in (a, w, kept, h, w1, b1, out, out2, part, colsum)]
    rc = _launch(dev, _lib().sod_gemm_nn, form, *ptrs, m, n, k)
    if rc != 0:
        raise RuntimeError(f"gemm_nn launch failed: cudaError {rc}")
    _count("nn")
    return (out, out2, colsum) if epilogue == "dgelu" else out


def gemm_nn_reference(a: torch.Tensor, w: torch.Tensor, epilogue: str, pre=None):
    """Plain PyTorch version of ``gemm_nn`` with the kernel's rounding
    points: v = f32(a) . f32(bf16(w)); bf16(v), v, or da = v * gelu'(hidden)
    rounded to bf16 with bf16(gelu(hidden)) and da's column sums in f32, the
    hidden f32(pre) or f32(h) . f32(bf16(w1))^T + f32(bf16(b1))."""
    if epilogue not in NN_EPILOGUES:
        raise ValueError(f"epilogue must be one of {NN_EPILOGUES}, got {epilogue!r}")
    bf16 = torch.bfloat16
    v = torch.matmul(a.float(), w.to(bf16).float())
    if epilogue == "bf16":
        return v.to(bf16)
    if epilogue == "f32":
        return v
    if isinstance(pre, tuple):
        h, w1, b1 = pre
        hid = torch.matmul(h.float(), w1.to(bf16).float().t()) + b1.to(bf16).float()
    else:
        hid = pre.float()
    da = v * _gelu_tanh_grad(hid)
    return da.to(bf16), _gelu_tanh(hid).to(bf16), da.sum(dim=0)


def gemm_tn(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [M, KA]^T . b [M, NB] in f32, bf16 operands, contracting the rows
    (the weight gradients: dW = g^T . x in torch's (out, in) layout)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[0] != b.shape[0]:
        raise ValueError(f"a must be [M, KA], b [M, NB], got {tuple(a.shape)}, {tuple(b.shape)}")
    (m, ka), nb = a.shape, b.shape[1]
    if m % 64 or ka % 64 or nb % 64:
        raise ValueError(f"need M, KA, NB % 64 == 0, got M={m}, KA={ka}, NB={nb}")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise ValueError("a and b must be bfloat16")
    if not _on_card([a, b], "gemm_tn"):
        return gemm_tn_reference(a, b)
    dev = a.device
    lib = _lib()
    out = torch.empty(ka, nb, device=dev, dtype=torch.float32)
    part = torch.empty(max(1, lib.sod_gemm_tn_part_floats(m, ka, nb)), device=dev,
                       dtype=torch.float32)
    rc = _launch(dev, lib.sod_gemm_tn, a.data_ptr(), b.data_ptr(), part.data_ptr(),
                 out.data_ptr(), m, ka, nb)
    if rc != 0:
        raise RuntimeError(f"gemm_tn launch failed: cudaError {rc}")
    _count("tn")
    return out


def gemm_tn_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of ``gemm_tn``: f32(a)^T . f32(b)."""
    return torch.matmul(a.float().t(), b.float())


def ln_backward(x: torch.Tensor, dh: torch.Tensor, g: torch.Tensor, ln_w: torch.Tensor,
                eps: float = 1e-6):
    """The LayerNorm backward + residual of K3's and K4's chains over rows:
    x [M, K] bf16 (the LayerNorm's input), dh [M, K] f32 (the gradient at
    its output), g [M, K] bf16 (the residual's gradient), ln_w [K] bf16.
    Returns (dx bf16, then f32 dLN scale, dLN bias, column sums of g)."""
    if x.dim() != 2 or tuple(dh.shape) != tuple(x.shape) or tuple(g.shape) != tuple(x.shape):
        raise ValueError("x, dh and g must be one [M, K] shape")
    m, k = x.shape
    if k % 8 or k > MAX_LN_DIM or tuple(ln_w.shape) != (k,):
        raise ValueError(f"need K % 8 == 0, K <= {MAX_LN_DIM} and ln_w [K], got K={k}, "
                         f"ln_w {tuple(ln_w.shape)}")
    if (x.dtype, dh.dtype, g.dtype, ln_w.dtype) != (torch.bfloat16, torch.float32,
                                                    torch.bfloat16, torch.bfloat16):
        raise ValueError("x, g and ln_w must be bfloat16, dh float32")
    if not _on_card([x, dh, g, ln_w], "ln_backward"):
        return ln_backward_reference(x, dh, g, ln_w, eps)
    dev = x.device
    lib = _lib()
    dx = torch.empty_like(x)
    part = torch.empty(lib.sod_ln_bwd_part_floats(m, k), device=dev, dtype=torch.float32)
    out3 = torch.empty(3, k, device=dev, dtype=torch.float32)
    rc = _launch(dev, lib.sod_ln_bwd, x.data_ptr(), dh.data_ptr(), g.data_ptr(), ln_w.data_ptr(),
                 eps, dx.data_ptr(), part.data_ptr(), out3.data_ptr(), m, k)
    if rc != 0:
        raise RuntimeError(f"ln_backward launch failed: cudaError {rc}")
    _count("ln_bwd")
    return dx, out3[0], out3[1], out3[2]


def ln_backward_reference(x: torch.Tensor, dh: torch.Tensor, g: torch.Tensor,
                          ln_w: torch.Tensor, eps: float = 1e-6):
    """Plain PyTorch version of ``ln_backward`` (the chains' plain versions'
    LayerNorm backward): xhat and inv of f32(x), dxhat = dh * f32(bf16(ln_w)),
    dx = g + inv * (dxhat - mean(dxhat) - xhat * mean(dxhat * xhat)) rounded
    to x's dtype; column sums of dh * xhat, dh and g in f32."""
    w = ln_w.to(torch.bfloat16).float()
    xhat, inv = _ln_pieces(x.float(), w, eps)
    dx, dls, dlb, dg = _ln_bwd_rows(dh.float(), xhat, inv, w, g.float())
    return dx.to(x.dtype), dls, dlb, dg


# ---------------------------------------------------------------------------
# ops/layers.py's bf16 linear on these products
# ---------------------------------------------------------------------------

def _dense(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and 16-byte aligned (a copy only where it is not):
    the weight, the bias and dy, which ``linear_takes`` does not see."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _LinearTC(torch.autograd.Function):
    """y = bf16(x . bf16(W)^T + f32(b)) over x's last axis, with
    ``linear``'s rounding points in both directions (module docstring)."""

    @staticmethod
    def forward(ctx, x, weight, bias):
        k = x.shape[-1]
        w = _dense(weight.to(torch.bfloat16))
        y = gemm(x.view(-1, k), w, _dense(bias.float()), "f32bias_bf16")
        ctx.save_for_backward(x, w)
        ctx.dtypes = weight.dtype, bias.dtype
        return y.view(*x.shape[:-1], w.shape[0])

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        want_x, want_w, want_b = ctx.needs_input_grad
        g = _dense(dy.reshape(-1, w.shape[0]))
        dx = gemm_nn(g, w, "bf16").view(x.shape) if want_x else None
        dw = (gemm_tn(g, x.view(-1, x.shape[-1])).to(torch.bfloat16).to(ctx.dtypes[0])
              if want_w else None)
        db = g.sum(0, dtype=torch.float32).to(ctx.dtypes[1]) if want_b else None
        return dx, dw, db


def linear_tc(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """``ops/layers.py`` ``linear(x, weight, bias)`` for bf16 x [..., K]
    that ``linear_takes`` accepts, through ``gemm``, ``gemm_nn`` and
    ``gemm_tn`` (their plain versions on the CPU)."""
    return _LinearTC.apply(x, weight, bias)
