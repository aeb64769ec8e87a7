"""The int8 block's four s8 products alone (``sod_tpu_torch.ops.fused_block_int8``
``qgemm`` / ``qgemm_reference``): each with its row quantiser, as the kernel
chain launches them, held to ``sod_tpu``'s quantised arithmetic.

* Each form's plain version against ``sod_tpu``'s ``_quant_rows`` and the
  integer product of ``_qdot`` run eagerly on the same f32 rows (for the LN
  forms, the rows after the port's LayerNorm): codes, scales and s32 sums
  exactly equal; the dequantised f32 values ``_qdot`` gives bit for bit; the
  QKV and proj epilogues bit for bit (one f32 add, one bf16 rounding, the
  same on both sides); fc1's tanh-GELU within one f32 ulp at the magnitude
  of its input (torch's and XLA's tanh round their last bit differently in
  ~1% of the values, and 0.5 h (1 + t) carries that bit at h's magnitude);
  fc2's bf16 output within one bf16 ulp.
* fc2's row scale, taken from fc1's maxima per 64 columns, equals
  ``_quant_rows``' scale bit for bit (max is order-free).
* The forms composed around the plain attention equal
  ``fused_vit_block_int8_reference`` bit for bit, with its codes and scales,
  masked and unmasked, at d 128 and 192 (a K that is no multiple of the
  kernel's 128-code stages).
* ``s8_plan``, the mirror of the kernel's tile plan, takes every shape of the
  int8 main path within the H100's 232,448 bytes of shared memory a block.
* The wrappers' refusals, the CPU route to the plain version, and the record
  checked once.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py`` (phase 14).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sod_tpu.ops.fused_block_int8 as jq
from sod_tpu_torch.ops import fused_block_int8 as fq
from sod_tpu_torch.ops.fused_attn import attention_plain
from sod_tpu_torch.ops.layers import layer_norm

M, D, HIDDEN = 128, 128, 512
SHAPES = {"qkv": (3 * D, D), "proj": (D, D), "fc1": (HIDDEN, D), "fc2": (D, HIDDEN)}


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _form_inputs(rng, form):
    """Rows, weights and the extras of one form at M x (N, K), numpy-seeded."""
    n, k = SHAPES[form]
    w = (rng.randn(n, k) * 0.02).astype(np.float32)
    wq, ws = fq.quantize_weight(_t(w))
    bias = _t(rng.randn(n) * 0.02)
    kw = {}
    if form in ("qkv", "fc1"):
        kw["ln"] = (_t(1 + 0.1 * rng.randn(k)), _t(0.1 * rng.randn(k)))
    rows = rng.randn(M, k) * np.exp(rng.randn(M, 1))
    rows[3] = 0                                                     # the amax floor
    if form in ("qkv", "proj"):
        a = _t(rows, torch.bfloat16)
    elif form == "fc1":
        a = _t(rows)
    else:                                    # a tanh-GELU hidden and fc1's maxima
        a = _t(np.maximum(rows, -0.17))
        kw["part"] = a.abs().reshape(M, -1, fq.PART_COLS).amax(-1)
    if form == "proj":
        kw["res"] = _t(rng.randn(M, n), torch.bfloat16)
    elif form == "fc2":
        kw["res"] = _t(rng.randn(M, n) * 2)
    return a, wq, ws, bias, kw


def _ulp32(x):
    return np.spacing(np.abs(x).astype(np.float32))


@pytest.mark.parametrize("form", list(SHAPES))
def test_form_plain_version_is_sod_tpus_arithmetic(rng, form):
    a, wq, ws, bias, kw = _form_inputs(rng, form)
    sk = {}
    out, part = fq.qgemm_reference(form, a, wq, ws, bias, scratch=sk, **kw)
    h = a.float()
    if "ln" in kw:
        h = layer_norm(h, *kw["ln"], 1e-6)
    hj = jnp.asarray(h.numpy())
    qj, sj = jq._quant_rows(hj)                       # eager: true divisions
    assert np.array_equal(sk["q"].numpy(), np.asarray(qj))
    assert np.array_equal(sk["s"].numpy(), np.asarray(sj)[:, 0])
    wj = jnp.asarray(wq.numpy().T)
    acc = np.asarray(jax.lax.dot(qj, wj, preferred_element_type=jnp.int32))
    assert np.array_equal(fq._int_matmul(sk["q"], wq).numpy(), acc.astype(np.float32))
    vj = jq._qdot(hj, wj, jnp.asarray(ws.numpy())[None])
    b = jnp.asarray(bias.numpy())
    if form == "qkv":
        ref = np.asarray((vj + b).astype(jnp.bfloat16).astype(jnp.float32))
        assert np.array_equal(out.float().numpy(), ref)
    elif form == "proj":
        ref = np.asarray(jnp.asarray(kw["res"].float().numpy()) + vj + b)
        assert out.dtype == torch.float32 and np.array_equal(out.numpy(), ref)
    elif form == "fc1":
        hid = vj + b
        ref = np.asarray(0.5 * hid * (1.0 + jnp.tanh(
            0.7978845608028654 * (hid + 0.044715 * hid ** 3))))
        got = out.numpy()
        assert np.all(np.abs(got - ref) <= _ulp32(np.asarray(hid)))
        assert np.array_equal(part.numpy(), np.abs(got).reshape(M, -1, 64).max(-1))
    else:
        ref = np.asarray((jnp.asarray(kw["res"].numpy()) + vj + b).astype(jnp.bfloat16)
                         .astype(jnp.float32))
        got = out.float().numpy()
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
        assert out.dtype == torch.bfloat16 and np.all(np.abs(got - ref) <= ulp)
    assert part is None or form == "fc1"


@pytest.mark.parametrize("k", [192, 1536, 3072])
def test_fc2_scale_from_partial_maxima_is_quant_rows_scale(rng, k):
    h = (rng.randn(64, k) * np.exp(2 * rng.randn(64, 1))).astype(np.float32)
    h[0] = 0
    h[1] = (np.arange(k) % 250 - 125 + 0.5).astype(np.float32)       # .5 ties at scale 1
    h[1, 0] = 127
    h[2, :] = -3.0                                                   # every column its max
    part = np.abs(h).reshape(64, -1, fq.PART_COLS).max(-1)
    q, s = fq._quant_with_amax(_t(h), _t(part).amax(-1, keepdim=True))
    qj, sj = jq._quant_rows(jnp.asarray(h))
    assert np.array_equal(s.numpy(), np.asarray(sj)) and np.array_equal(q.numpy(), np.asarray(qj))
    qt, st = fq.quant_rows(_t(h))
    assert torch.equal(st, s) and torch.equal(qt, q)


def _compose(x, bq, n_heads, n_real, key_mask, scratch):
    """The four forms through ``qgemm`` around the plain attention."""
    b, n, d = x.shape
    rows = x.reshape(b * n, d)

    def form(name, a, **kw):
        sk = {}
        out, part = fq.qgemm(name, a, bq[name]["q"], bq[name]["s"], bq[name]["b"],
                             scratch=sk, **kw)
        scratch[f"q_{name}"], scratch[f"s_{name}"] = sk["q"], sk["s"]
        return out, part

    qkv, _ = form("qkv", rows, ln=(bq["norm1"]["weight"], bq["norm1"]["bias"]))
    attn = attention_plain(qkv.reshape(b, n, 3 * d).float(), n_heads, n_real, key_mask)
    x1, _ = form("proj", attn.to(torch.bfloat16).reshape(b * n, d), res=rows)
    hid, part = form("fc1", x1, ln=(bq["norm2"]["weight"], bq["norm2"]["bias"]))
    out, _ = form("fc2", hid, part=part, res=x1)
    return out.reshape(b, n, d)


@pytest.mark.parametrize("d,n_heads", [(128, 2), (192, 3)])
@pytest.mark.parametrize("masked", [False, True])
def test_forms_compose_to_the_block_reference(rng, d, n_heads, masked):
    state = {}
    for name, (n, k) in {"attn.qkv": (3 * d, d), "attn.proj": (d, d),
                         "mlp.fc1": (4 * d, d), "mlp.fc2": (d, 4 * d)}.items():
        state[f"blocks.0.{name}.weight"] = _t(rng.randn(n, k) * 0.02)
        state[f"blocks.0.{name}.bias"] = _t(rng.randn(n) * 0.02)
    for name in ("norm1", "norm2"):
        state[f"blocks.0.{name}.weight"] = _t(1 + 0.1 * rng.randn(d))
        state[f"blocks.0.{name}.bias"] = _t(0.1 * rng.randn(d))
    bq = fq.quantize_vit_blocks(state, prefix="blocks.")[0]
    x = _t(rng.randn(2, 128, d), torch.bfloat16)
    km = None
    if masked:
        km = torch.from_numpy(rng.rand(2, 128) > 0.4)
        km[:, 0] = True
    sc, sr = {}, {}
    got = _compose(x, bq, n_heads, 100, km, sc)
    ref = fq.fused_vit_block_int8_reference(x, bq, n_heads, 100, key_mask=km, scratch=sr)
    assert got.dtype == ref.dtype == torch.bfloat16 and torch.equal(got, ref)
    for name in fq.MATS:
        assert torch.equal(sc[f"q_{name}"], sr[f"q_{name}"])
        assert torch.equal(sc[f"s_{name}"], sr[f"s_{name}"])


MAIN_PATH_ROWS = [b * n for b in (1, 2, 4, 8, 16, 32, 64) for n in range(256, 1025, 128)]


@pytest.mark.parametrize("d", [192, 384, 768])
def test_s8_plan_takes_every_int8_main_path_shape(d):
    for m in MAIN_PATH_ROWS:
        for (n, k), form in zip(((3 * d, d), (d, d), (4 * d, d), (d, 4 * d)), fq.S8_FORMS):
            elem = fq.S8_ROW_ELEM[form]
            c, tiles, lg = fq.s8_plan(m, n, k, elem)
            assert c >= 0, (m, n, k)
            wg, bn = fq.S8_CONFIGS[c]
            assert n % bn == 0 and 1 <= lg <= 3 and tiles >= 1
            assert fq.s8_smem(wg, bn, k, 1 << lg) <= fq.SMEM_MAX == 232448
            assert -(-(n // bn) // tiles) * tiles >= n // bn
            if elem:                                 # the prologue's row jobs
                rows = fq.s8_job_rows(elem, k, bn, 64 * wg)
                assert rows >= 1 and rows * k * elem <= bn * 128 and (64 * wg) % rows == 0
                assert rows << lg >= 16 * wg                 # a row for every quarter warp


def test_s8_plan_follows_the_rule():
    """B=8 at ViT-S: 64-row panels for QKV, proj and fc2 (fc2's 1536-code
    panel leaves room for the whole 8-stage ring), 128-row ones for fc1;
    at B=1 64 x 64 tiles (fc2 streams its rows as column chunks, so ViT-B's
    3072-wide hidden takes them too, with four stages)."""
    assert fq.s8_plan(7168, 1152, 384, 2) == (1, 9, 3)
    assert fq.s8_plan(7168, 1536, 384, 4) == (0, 6, 3)
    assert fq.s8_plan(7168, 384, 1536, 0) == (1, 3, 3)
    assert fq.s8_plan(896, 384, 384, 2) == (2, 1, 3)
    assert fq.s8_plan(512, 768, 3072, 0) == (2, 1, 2)
    assert fq.s8_plan(512, 3072, 768, 4) == (2, 3, 3)     # ViT-B's fc1: 2 rows a job
    assert fq.s8_lg_stages(1, 128, 3072) == 1 and fq.s8_lg_stages(2, 128, 3072) == -1
    assert fq.s8_job_rows(2, 384, 128, 64) == 16 and fq.s8_job_rows(4, 1536, 64, 64) == 1
    assert fq.s8_job_rows(4, 3072, 64, 64) == 0


@pytest.mark.parametrize("form", list(SHAPES))
def test_qgemm_on_cpu_is_the_plain_version(rng, form):
    a, wq, ws, bias, kw = _form_inputs(rng, form)
    before = fq.form_launches
    sk, sr = {}, {}
    got = fq.qgemm(form, a, wq, ws, bias, scratch=sk, **kw)
    ref = fq.qgemm_reference(form, a, wq, ws, bias, scratch=sr, **kw)
    assert torch.equal(got[0], ref[0]) and fq.form_launches == before
    assert got[0].dtype == fq.S8_FORMS[form][3]
    assert torch.equal(sk["q"], sr["q"]) and torch.equal(sk["s"], sr["s"])


REJECT = ["form", "rows_not_64", "k_not_64", "a_dtype", "weight_dtype", "ln_missing",
          "ln_shape", "res_missing", "res_dtype", "part_missing", "part_shape",
          "k_beyond_1024", "no_cuda_device"]


@pytest.mark.parametrize("case", REJECT)
def test_qgemm_rejects_what_the_kernel_does_not_take(rng, case):
    form = {"ln_missing": "qkv", "ln_shape": "fc1", "res_missing": "proj", "res_dtype": "fc2",
            "part_missing": "fc2", "part_shape": "fc2"}.get(case, "qkv")
    a, wq, ws, bias, kw = _form_inputs(rng, form)
    if case == "form":
        form = "fc3"
    elif case == "rows_not_64":
        a = a[:100]
    elif case == "k_not_64":
        a, wq = a[:, :96].contiguous(), wq[:, :96].contiguous()
        kw["ln"] = tuple(t[:96] for t in kw["ln"])
    elif case == "a_dtype":
        a = a.float()
    elif case == "weight_dtype":
        wq = wq.float()
    elif case == "ln_missing":
        del kw["ln"]
    elif case == "ln_shape":
        kw["ln"] = (kw["ln"][0][:64], kw["ln"][1])
    elif case == "res_missing":
        del kw["res"]
    elif case == "res_dtype":
        kw["res"] = kw["res"].to(torch.bfloat16)
    elif case == "part_missing":
        del kw["part"]
    elif case == "part_shape":
        kw["part"] = kw["part"][:, :-1]
    elif case == "k_beyond_1024":
        k = 1152
        a = _t(rng.randn(M, k), torch.bfloat16)
        wq = torch.zeros(3 * D, k, dtype=torch.int8)
        kw["ln"] = (torch.ones(k), torch.zeros(k))
    elif case == "no_cuda_device":
        a = a.to("meta")
    with pytest.raises(ValueError):
        fq.qgemm(form, a, wq, ws, bias, **kw)


def test_card_entries_refuse_cpu_tensors():
    with pytest.raises(ValueError):
        fq.quant_rows_cuda(torch.zeros(8, 64))
    with pytest.raises(ValueError):
        fq.qgemm_bias_bf16_cuda(torch.zeros(64, 64, dtype=torch.int8), torch.ones(64),
                                torch.zeros(64, 64, dtype=torch.int8), torch.ones(64),
                                torch.zeros(64))


def test_record_is_checked_once(rng, monkeypatch):
    """``quantize_vit_blocks`` checks each record; a block call on the same
    record checks it again only when one of its tensors was replaced."""
    state = {f"blocks.0.{k}": v for k, v in {
        "attn.qkv.weight": _t(rng.randn(3 * D, D)), "attn.qkv.bias": _t(rng.randn(3 * D)),
        "attn.proj.weight": _t(rng.randn(D, D)), "attn.proj.bias": _t(rng.randn(D)),
        "mlp.fc1.weight": _t(rng.randn(HIDDEN, D)), "mlp.fc1.bias": _t(rng.randn(HIDDEN)),
        "mlp.fc2.weight": _t(rng.randn(D, HIDDEN)), "mlp.fc2.bias": _t(rng.randn(D)),
        "norm1.weight": torch.ones(D), "norm1.bias": torch.zeros(D),
        "norm2.weight": torch.ones(D), "norm2.bias": torch.zeros(D)}.items()}
    bq = fq.quantize_vit_blocks(state, prefix="blocks.")[0]
    calls = []
    real = fq.check_record
    monkeypatch.setattr(fq, "check_record", lambda r: calls.append(1) or real(r))
    x = torch.zeros(1, 128, D, dtype=torch.bfloat16)
    fq.fused_vit_block_int8(x, bq, 2, 100)
    assert calls == []
    bq["fc2"]["b"] = bq["fc2"]["b"].clone()
    fq.fused_vit_block_int8(x, bq, 2, 100)
    assert calls == [1]
    bq["fc2"]["b"] = bq["fc2"]["b"].double()
    with pytest.raises(ValueError, match="fc2"):
        fq.fused_vit_block_int8(x, bq, 2, 100)
