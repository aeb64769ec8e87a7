"""The forward GEMM of the ViT block kernels, alone (``sod_tpu_torch.ops.gemm``).

On the CPU ``gemm`` runs its plain version ``gemm_reference``.  Held here:
its four forms composed with the plain attention are K1's plain version
``fused_vit_block_reference`` bit for bit, two of them K4's plain forward
(output and saved pre-GELU hidden) bit for bit, and one LN form and one
residual form agree with ``sod_tpu``'s XLA ``layer_norm`` and ``linear`` on
f32 inputs within 1e-4 (f32 sums in another order; the inputs are bf16
values, so the bf16 casts of both sides are exact).  The CUDA kernel itself
is held against ``gemm_reference`` on the card by ``chip_smoke.py`` (phase 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.ops import layers as jl
from sod_tpu_torch.models.vit import Block, ViTConfig
from sod_tpu_torch.ops import fused_block as fb
from sod_tpu_torch.ops import fused_mlp as fm
from sod_tpu_torch.ops import gemm as G

BF16 = torch.bfloat16
D, H, N_PAD, N_REAL = 128, 2, 128, 100


def _block(rng, d=D, n_heads=H):
    blk = Block(ViTConfig(embed_dim=d, n_heads=n_heads, depth=1, pos_grid=4))
    sd = {}
    for name, p in blk.state_dict().items():
        scale = 0.1 if name.startswith("norm") else 0.02
        base = 1.0 if name.startswith("norm") and name.endswith("weight") else 0.0
        sd[name] = torch.from_numpy(
            (base + rng.standard_normal(tuple(p.shape)) * scale).astype(np.float32))
    blk.load_state_dict(sd)
    return blk.to(BF16)


def _x(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(BF16)


def _attention(qkv, b, n, n_heads, n_real, key_mask):
    """K1's plain attention (``fused_vit_block_reference``'s lines) on f32
    copies of bf16 qkv rows [b * n, 3d]: bf16 head outputs [b * n, d]."""
    d = qkv.shape[-1] // 3
    hd = d // n_heads
    qkv = qkv.float().reshape(b, n, 3 * d)
    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, n, n_heads, hd).transpose(1, 2)
               for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * hd ** -0.5
    key_ok = (torch.arange(n) < n_real)[None, :].expand(b, n)
    if key_mask is not None:
        key_ok = key_ok & key_mask
    s = torch.where(key_ok[:, None, None, :], s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    attn = torch.matmul(p.to(BF16).float(), v).to(BF16).float()
    return attn.transpose(1, 2).reshape(b * n, d).to(BF16)


@pytest.mark.parametrize("masked", [False, True])
def test_forms_compose_to_k1_plain_version(masked):
    """QKV, proj, fc1 and fc2 as ``gemm_reference`` forms around the plain
    attention give ``fused_vit_block_reference``'s block output bit for bit."""
    rng = np.random.default_rng(0)
    blk, x = _block(rng), _x(rng, 2, N_PAD, D)
    key_mask = None
    if masked:
        key_mask = torch.from_numpy(rng.random((2, N_PAD)) > 0.3)
        key_mask[:, 0] = True
    x2 = x.reshape(-1, D)
    qkv = G.gemm_reference(x2, blk.attn.qkv.weight, blk.attn.qkv.bias, "bias_bf16",
                           ln=(blk.norm1.weight, blk.norm1.bias))
    attn = _attention(qkv, 2, N_PAD, H, N_REAL, key_mask)
    x1 = G.gemm_reference(attn, blk.attn.proj.weight, blk.attn.proj.bias, "res_f32", res=x2)
    hid = G.gemm_reference(x1, blk.mlp.fc1.weight, blk.mlp.fc1.bias, "gelu_bf16",
                           ln=(blk.norm2.weight, blk.norm2.bias))
    out = G.gemm_reference(hid, blk.mlp.fc2.weight, blk.mlp.fc2.bias, "res_bf16", res=x1)
    assert x1.dtype == torch.float32 and out.dtype == BF16
    want = fb.fused_vit_block_reference(x, blk, H, N_REAL, key_mask=key_mask)
    assert torch.equal(out.reshape(x.shape), want)


def test_forms_give_k4_plain_forward():
    """fc1 + GELU and fc2 + residual on bf16 rows are K4's plain forward; the
    LN + bias form is its saved pre-GELU hidden, bit for bit."""
    rng = np.random.default_rng(1)
    blk, x = _block(rng), _x(rng, 3, 64, D)
    x2 = x.reshape(-1, D)
    ln = (blk.norm2.weight, blk.norm2.bias)
    hid = G.gemm_reference(x2, blk.mlp.fc1.weight, blk.mlp.fc1.bias, "gelu_bf16", ln=ln)
    out = G.gemm_reference(hid, blk.mlp.fc2.weight, blk.mlp.fc2.bias, "res_bf16", res=x2)
    saved = G.gemm_reference(x2, blk.mlp.fc1.weight, blk.mlp.fc1.bias, "bias_bf16", ln=ln)
    want_out, want_a = fm.fused_ln_mlp_save_reference(x, blk)
    assert torch.equal(out.reshape(x.shape), want_out)
    assert torch.equal(saved.reshape(want_a.shape), want_a)
    assert torch.equal(out.reshape(x.shape), fm.fused_ln_mlp_reference(x, blk))


def _bf16_values(rng, *shape, scale=1.0, offset=0.0):
    """f32 numpy values that bf16 represents exactly."""
    a = torch.from_numpy((offset + rng.standard_normal(shape) * scale).astype(np.float32))
    return a.to(BF16).float().numpy()


@pytest.mark.parametrize("form", ["layer_norm", "residual"])
def test_reference_matches_sod_tpu_xla_math(form):
    """``gemm_reference`` against ``sod_tpu.ops.layers`` ``layer_norm`` and
    ``linear`` on f32 inputs: LN (output rounded to bf16, the rounding point
    of every LN form) then the product + bias, and residual + product +
    bias, both in f32 (``res_f32``), within 1e-4."""
    rng = np.random.default_rng(2)
    m, n, k = 64, 192, 128
    a = _bf16_values(rng, m, k)
    w = _bf16_values(rng, k, n, scale=0.05)          # sod_tpu's (in, out) layout
    b = _bf16_values(rng, n, scale=0.05)
    res = rng.standard_normal((m, n)).astype(np.float32)
    t = torch.from_numpy
    if form == "layer_norm":
        scale = _bf16_values(rng, k, scale=0.1, offset=1.0)
        shift = _bf16_values(rng, k, scale=0.1)
        h = jl.layer_norm({"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)},
                          jnp.asarray(a)).astype(jnp.bfloat16).astype(jnp.float32)
        want = jl.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)}, h)
        got = G.gemm_reference(t(a), t(w.T.copy()), t(b), "res_f32",
                               ln=(t(scale), t(shift)), res=torch.zeros(m, n))
    else:
        want = jnp.asarray(res) + jl.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                                            jnp.asarray(a))
        got = G.gemm_reference(t(a), t(w.T.copy()), t(b), "res_f32", res=t(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def _form_inputs(rng, epilogue, m=128, n=192, k=64):
    ln = None
    a_dtype, res_dtype = {"bias_bf16": (BF16, None), "res_f32": (BF16, BF16),
                          "gelu_bf16": (torch.float32, None),
                          "res_bf16": (BF16, torch.float32),
                          "f32bias_bf16": (BF16, None)}[epilogue]
    if epilogue in ("bias_bf16", "gelu_bf16"):
        ln = ((1 + 0.1 * _x(rng, k).float()).to(BF16), (0.1 * _x(rng, k).float()).to(BF16))
    a = _x(rng, m, k).to(a_dtype)
    res = None if res_dtype is None else _x(rng, m, n).to(res_dtype)
    bias = 0.02 * torch.from_numpy(rng.standard_normal(n).astype(np.float32))
    return dict(a=a, w=(0.02 * _x(rng, n, k).float()).to(BF16),
                bias=bias if epilogue == "f32bias_bf16" else bias.to(BF16),
                epilogue=epilogue, ln=ln, res=res)


@pytest.mark.parametrize("epilogue", G.EPILOGUES)
def test_gemm_on_cpu_is_the_plain_version(epilogue):
    """For a CPU tensor the wrapper runs ``gemm_reference``, counting no
    kernel launch; the output has the form's dtype."""
    kw = _form_inputs(np.random.default_rng(4), epilogue)
    before = G.launches
    got = G.gemm(**kw)
    assert G.launches == before
    assert torch.equal(got, G.gemm_reference(**kw))
    assert got.dtype == (torch.float32 if epilogue == "res_f32" else BF16)
    assert got.shape == (128, 192)


def _bad(kw, **change):
    return {**kw, **change}


@pytest.mark.parametrize("case", ["rows", "cols", "depth", "ln_width", "dtype_form",
                                  "res_shape", "epilogue", "weight_dtype", "chain",
                                  "f32_bias_form", "bf16_bias_of_f32bias"])
def test_gemm_rejects_what_the_kernel_does_not_take(case):
    rng = np.random.default_rng(5)
    kw = _form_inputs(rng, "bias_bf16")
    bad = {
        "rows": lambda: _bad(kw, a=kw["a"][:0]),                         # M == 0
        "cols": lambda: _bad(kw, w=kw["w"][:160], bias=kw["bias"][:160]),  # N % 64
        "depth": lambda: _form_inputs(rng, "res_f32", k=48),             # K % 32
        "ln_width": lambda: _form_inputs(rng, "bias_bf16", k=1088),      # LN K > 1024
        "dtype_form": lambda: _bad(kw, a=kw["a"].float()),               # no such form
        "res_shape": lambda: _bad(_form_inputs(rng, "res_bf16"),
                                  res=torch.zeros(128, 64)),
        "epilogue": lambda: _bad(kw, epilogue="relu_bf16"),
        "weight_dtype": lambda: _bad(kw, w=kw["w"].float()),
        "chain": lambda: _bad(kw, w=kw["w"][:, :32]),                    # K mismatch
        "f32_bias_form": lambda: _bad(kw, bias=kw["bias"].float()),      # bf16 bias form
        "bf16_bias_of_f32bias": lambda: _bad(_form_inputs(rng, "f32bias_bf16"),
                                             bias=kw["bias"]),
    }[case]()
    with pytest.raises(ValueError):
        G.gemm(**bad)


def test_shapes_of_the_main_paths_are_accepted():
    """The wrappers take d 1024 (the LN panel's widest, K1's MAX_DIM) and
    K4's 6336 training rows (6280 padded); so does the GEMM."""
    rng = np.random.default_rng(6)
    assert fb.MAX_DIM == G.MAX_LN_DIM == 1024
    blk = _block(rng, 1024, 16)
    fb.check_tokens(_x(rng, 1, 128, 1024), blk, 16, 100, None)
    fm._check(_x(rng, 2, 1024), [p for p in fm._weights(blk)])
    rows = fm._pad_rows(torch.zeros(6280, 384, dtype=BF16))
    assert rows.shape == (6336, 384)
    kw = _form_inputs(rng, "bias_bf16", m=6336, n=1152, k=1024)
    assert G._check(kw["a"], kw["w"], kw["bias"], "bias_bf16", kw["ln"], None) == 0


# ---------------------------------------------------------------------------
# ops/layers.py linear on these products (ops/gemm.py linear_tc)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows", [64, 192])
def test_f32bias_form_matches_sod_tpu_linear(rows):
    """The f32-bias form's plain version against ``sod_tpu``'s ``linear``
    on bf16 rows (f32 weight cast to bf16, f32 bias added to the f32
    product, one rounding): within one bf16 ulp of each output, nearly all
    equal (f32 sums in another order flip single roundings)."""
    rng = np.random.default_rng(7)
    k, n = 128, 192
    x = _x(rng, rows, k)
    w = (0.05 * rng.standard_normal((k, n))).astype(np.float32)   # sod_tpu's (in, out)
    b = (0.5 * rng.standard_normal(n)).astype(np.float32)
    want = jl.linear({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                     jnp.asarray(x.float().numpy()).astype(jnp.bfloat16))
    want = np.asarray(want.astype(jnp.float32))
    got = G.gemm_reference(x, torch.from_numpy(w.T.copy()), torch.from_numpy(b),
                           "f32bias_bf16")
    assert got.dtype == BF16
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -7, atol=0)
    assert (got == want).mean() > 0.99


def _linear_inputs(rng, shape, n, weight_dtype=torch.float32, x_grad=True):
    x = _x(rng, *shape).requires_grad_(x_grad)
    w = (0.05 * torch.from_numpy(rng.standard_normal((n, shape[-1])).astype(np.float32))
         ).to(weight_dtype).requires_grad_()
    b = (0.5 * torch.from_numpy(rng.standard_normal(n).astype(np.float32))).requires_grad_()
    return x, w, b


def _within_bf16_ulp(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), want.detach().float().numpy(),
                               rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("case", ["2d", "3d", "3d_input_without_grad", "bf16_weight",
                                  "row_tail"])
def test_linear_tc_matches_the_f32_products(case):
    """``linear_tc`` (its products' plain versions on the CPU) against
    ``linear_f32`` under autograd: y, dx, dW and db in the dtypes the f32
    products give them (dW rounded to bf16, then the weight's dtype; db the
    bias's), each within one bf16 ulp; no dx for an input without grad."""
    from sod_tpu_torch.ops import layers as L

    rng = np.random.default_rng(8)
    shape = {"2d": (128, 64), "bf16_weight": (128, 64),
             "row_tail": (3, 37, 128)}.get(case, (2, 64, 128))      # 111 rows
    weight_dtype = BF16 if case == "bf16_weight" else torch.float32
    x, w, b = _linear_inputs(rng, shape, 192, weight_dtype,
                             x_grad=case != "3d_input_without_grad")
    gy = _x(rng, *shape[:-1], 192)
    got = G.linear_tc(x, w, b)
    got.backward(gy)
    x2, w2, b2 = (t.detach().clone().requires_grad_(t.requires_grad) for t in (x, w, b))
    want = L.linear_f32(x2, w2, b2)
    want.backward(gy)
    assert got.dtype == BF16 and got.shape == want.shape
    _within_bf16_ulp(got, want)
    for t, t2 in ((w, w2), (b, b2)):
        assert t.grad.dtype == t2.grad.dtype == t.dtype
        _within_bf16_ulp(t.grad, t2.grad)
    assert torch.equal(w.grad, w.grad.to(BF16).to(w.dtype))      # bf16-valued
    if x.requires_grad:
        assert x.grad.dtype == BF16 and x.grad.shape == x.shape
        _within_bf16_ulp(x.grad, x2.grad)
    else:
        assert x.grad is None


@pytest.mark.parametrize("m,n,k,want", [
    (1280, 2, 384, False),                            # the objectness classifier
    (6280, 384, 384, True),                           # B=8 serving rows (6280 % 64 = 8)
    (784, 384, 384, True),                            # the decoder's K/V of one image
    (20, 384, 384, True),                             # one image's queries
    (0, 384, 384, False),                             # no rows
    (1280, 384, 48, False),                           # K % 64
    (10952, 1536, 588, False),                        # ViT-g/14's patch embedding (K 588)
    (50240, 1152, 384, True),                         # the cell's QKV
    (50240, 384, 384, True),                          # proj
    (50240, 1536, 384, True),                         # fc1
    (50240, 384, 1536, True),                         # fc2
    (50176, 384, 192, True),                          # the patch embedding
    (50176, 384, 384, True),                          # the decoder's K and V
    (1280, 384, 384, True),                           # the decoder's queries
    (1280, 1536, 384, True),                          # its FFN
    (10992, 4608, 1536, True),                        # ViT-g/14-reg at B=8: qkv (10992 % 64 = 48)
    (10992, 1536, 1536, True),                        # proj
    (10992, 8192, 1536, True),                        # SwiGLU w12
    (10992, 1536, 4096, True),                        # w3
    (10952, 384, 1536, True),                         # the adapter (10952 % 64 = 8)
    (10952, 384, 384, True),                          # the decoder's K and V
    (160, 384, 384, True),                            # the decoder's queries at B=8
])
def test_tc_shape_rule(m, n, k, want):
    """The dispatch rule's shapes as a device-independent predicate: N and K
    multiples of 64, any row count above 0."""
    assert G.tc_shape(m, n, k) is want


@pytest.mark.parametrize("case,want", [
    ("taken", True), ("no_bias", False), ("rows", True), ("n2", False),
    ("strided", False), ("misaligned", False)])
def test_linear_takes(case, want):
    """``linear_takes`` on bf16 x: a bias, a shape ``tc_shape`` accepts (80
    rows, no multiple of 64, are one), and x one contiguous, 16-byte aligned
    [M, K] matrix."""
    x = torch.zeros(2, 64, 64, dtype=BF16)
    w, b = torch.zeros(128, 64), torch.zeros(128)
    if case == "no_bias":
        b = None
    elif case == "rows":
        x = torch.zeros(2, 40, 64, dtype=BF16)
    elif case == "n2":
        w, b = w[:2], b[:2]
    elif case == "strided":
        x = torch.zeros(2, 65, 64, dtype=BF16)[:, 1:]
    elif case == "misaligned":
        x = torch.zeros(2 * 64 * 64 + 1, dtype=BF16)[1:].view(2, 64, 64)
    assert G.linear_takes(x, w, b) is want


@pytest.mark.parametrize("case,counts", [
    ("taken", (1, 0)), ("n2", (0, 1)), ("rows", (1, 0)), ("no_bias", (0, 1)),
    ("strided", (0, 1)), ("f32", (0, 0))])
def test_linear_counters_and_dispatch(monkeypatch, case, counts):
    """With ``linear`` made to see its input on the card, a call goes
    through ``linear_tc`` and counts ``tc_linears`` only where the rule and
    its layout allow; every other bf16 call counts ``f32_linears`` and runs
    the f32 products; an f32 call counts neither.  Both give the same
    numbers here (the CPU's plain versions)."""
    from sod_tpu_torch.ops import layers as L

    monkeypatch.setattr(L, "_on_card", lambda x: True)
    rng = np.random.default_rng(9)
    shape, n, bias = (2, 64, 64), 128, True
    if case == "n2":
        n = 2
    elif case == "rows":
        shape = (2, 40, 64)
    elif case == "no_bias":
        bias = False
    elif case == "strided":
        shape = (2, 65, 64)
    x, w, b = _linear_inputs(rng, shape, n)
    if case == "strided":
        x = x[:, 1:]                                   # 128 rows, not one [M, K] matrix
    elif case == "f32":
        x = x.float()
    calls, linear_tc = [], G.linear_tc
    monkeypatch.setattr(G, "linear_tc", lambda *a: calls.append(1) or linear_tc(*a))
    before = (L.tc_linears, L.f32_linears)
    got = L.linear(x, w, b if bias else None)
    assert (L.tc_linears - before[0], L.f32_linears - before[1]) == counts
    assert len(calls) == counts[0]
    _within_bf16_ulp(got, L.linear_f32(x, w, b if bias else None))
