"""The ResNet-50 MaskFormer (``arch: resnet50``) against ``sod_tpu``'s, on
the same weights (a sod_tpu tree drawn with numpy, carried over by
``state_dict_from_jax``) and the same numpy inputs: 32x32 images (res5 4x4,
d 384), 2 decoder layers, 4 queries.

* f32, eval mode: <= 1e-4 on ``mask_pred``, ``objectness`` and
  ``features`` (measured 5.5e-5).  Train mode (BatchNorm on the batch's
  statistics): the statistics of all 53 BatchNorms <= 1e-4 relative to
  their scale (measured 2.8e-5), the outputs <= 2e-3 (measured 5.6e-4).
  The second bound is f32 noise, not a looser port: batch statistics of a
  random ResNet-50 amplify rounding layer by layer; on sod_tpu's own init
  weights its f32 forward lies 1.1e-3 from the same math in f64 at res5,
  the port's 0.9e-3.
* bf16 (XLA's excess precision off, so sod_tpu rounds as written): each
  stage on its own (the stem, the first block of each layer and a later
  one of layers 3 and 4: stride 2, dilation 2 and 4) from the same bf16
  input, its output within one bf16 unit roundoff (2^-8) in relative L2
  and its train-mode statistics within 1e-3 relative.  A conv's f32 sums
  in another order flip single bf16 roundings (1 in ~4000 outputs), and
  the block's next conv spreads each flip over every output channel
  (measured: 0 in the stem, up to 6.7e-4 in eval mode and 2.0e-3 in train
  mode, statistics 2.6e-4).  The whole bf16 forward is chaotic at the ulp
  level: in eval mode the masks agree to a mean of 0.01 (measured 0.002),
  objectness to 1e-3 (2.3e-4).
* one f32 train step against ``make_train_step``: metrics <= 1e-3
  relative (measured 4.7e-5 on the grad norm), the BN buffers after the
  step <= 1e-4 relative (3.0e-5), the parameter updates as
  tests/test_torch_train_step.py's bf16 ones (Adam's first step is near
  sign-sized, so gradient noise flips small elements): correlation > 0.99,
  >= 97% within 1e-5 (measured 0.998 and 99.1%).  Under accumulation the
  buffers are the mean of the micro-batches' statistics.
* the canvas forward refuses the ResNet, as sod_tpu's asserts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sod_tpu.config import Config
from sod_tpu.models import maskformer as jmf
from sod_tpu.models import resnet as jr
from sod_tpu_torch.models import maskformer as tmf
from sod_tpu_torch.models import resnet as tr
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import METRIC_KEYS, make_train_step
from test_torch_model_options import NO_EXCESS, _batch, _jax_tree, _jcfg, _np, _port, _steps, _tcfg

TRAIN_F32_ATOL = 2e-3


@pytest.fixture(scope="module")
def resnet():
    jcfg = _jcfg(arch="resnet50")
    params = _jax_tree(jcfg, 0)
    return jcfg, params, _port(params, _tcfg(arch="resnet50"))


def _jax_bn_stats(tree, prefix=""):
    """sod_tpu's stats tree -> {port BN path: (mean, var)}."""
    out = {}
    for k, v in tree.items():
        if set(v) == {"mean", "var"}:
            name = {"down_bn": "downsample.1"}.get(k, k)
            out[prefix + name] = (np.asarray(v["mean"]), np.asarray(v["var"]))
        elif k == "prefix":
            out.update(_jax_bn_stats(v, ""))
        else:
            sub = k.replace("block", "") if k.startswith("block") else k
            out.update(_jax_bn_stats(v, f"{prefix}{sub}."))
    return out


# ------------------------------------------------------------ ResNet-50, f32
@pytest.mark.parametrize("train", [False, True])
def test_resnet_forward_f32_matches_sod_tpu(resnet, train):
    jcfg, params, model = resnet
    x = np.random.default_rng(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    ref = jax.jit(lambda p, x: jmf.maskformer_apply(p, x, jcfg, train=train))(
        params, jnp.asarray(x))
    out = model(torch.from_numpy(x), train=train)
    assert out["mask_pred"].shape == ref["mask_pred"].shape == (2, 2, 4, 8, 8)
    tol = TRAIN_F32_ATOL if train else 1e-4
    for k in ("mask_pred", "objectness", "features"):
        np.testing.assert_allclose(_np(out[k]), _np(ref[k]), atol=tol, rtol=0, err_msg=k)
    assert ("batch_stats" in out) is train
    if train:
        theirs = _jax_bn_stats(ref["batch_stats"]["encoder"])
        assert set(theirs) == set(out["batch_stats"]) and len(theirs) == 53
        for name, (mean, var) in theirs.items():
            got = out["batch_stats"][name]
            for a, b in ((got["mean"], mean), (got["var"], var)):
                np.testing.assert_allclose(_np(a), b, rtol=0,
                                           atol=1e-4 * max(1.0, np.abs(b).max()),
                                           err_msg=name)


# ----------------------------------------------------------- ResNet-50, bf16
def _bf16_ulp(a):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 1e-30))) - 7)


# (layer, block): stride 2 with a downsample, dilation 2 (first and later
# blocks of layer3), dilation 4 after the stride was removed (layer4)
BLOCKS = ((1, 0), (2, 0), (3, 0), (3, 1), (4, 0), (4, 1))


@pytest.mark.parametrize("train", [False, True])
def test_resnet_bf16_stages_match_sod_tpu(resnet, train):
    _, params, model = resnet
    enc, geo = params["encoder"], tr._stage_geometry(8)
    r = np.random.default_rng(1)
    momentum = 0.1
    sides = {1: 8, 2: 8, 3: 4, 4: 4}           # each layer's input grid at 32 px

    def check(name, j_out, t_out, j_stats, t_stats):
        a, b = _np(j_out), _np(t_out)
        rel = np.linalg.norm(a - b) / np.linalg.norm(a)
        srel = 0.0
        for bn, (mean, var) in _jax_bn_stats(j_stats).items():
            got = t_stats[bn]
            for g, w in ((got["mean"], mean), (got["var"], var)):
                srel = max(srel, np.linalg.norm(_np(g) - w) / np.linalg.norm(w))
        assert rel <= 4e-3 and srel <= 1e-3, (name, rel, srel)

    # the stem: 7x7/2 conv, BN, relu, max pool
    x = jnp.asarray(r.standard_normal((2, 32, 32, 3)), jnp.bfloat16)

    def jstem(p, x):
        stats = {}
        h = jax.nn.relu(jr._bn(p, "bn1", jr.conv(p["conv1"], x, stride=2), train, momentum,
                               stats))
        return jr.max_pool_3x3_s2(h), {"prefix": stats}

    j_out, j_stats = jax.jit(jstem).lower(enc["prefix"], x).compile(
        compiler_options=NO_EXCESS)(enc["prefix"], x)
    t_stats = {}
    tx = torch.from_numpy(_np(x)).bfloat16().permute(0, 3, 1, 2)
    bn = _bn_fn(train, t_stats, "")
    t_out = tr.max_pool_3x3_s2(torch.relu(bn("bn1", model.encoder.bn1,
                                             tr.conv(model.encoder.conv1.weight, tx, 2))))
    check("stem", j_out, t_out.permute(0, 2, 3, 1), j_stats if train else {}, t_stats)

    for li, bi in BLOCKS:
        first_stride, first_dil, rest_dil = geo[li - 1]
        stride = first_stride if bi == 0 else 1
        dil = first_dil if bi == 0 else rest_dil
        blk = getattr(model.encoder, f"layer{li}")[bi]
        side = sides[li]
        x = jnp.asarray(r.standard_normal((2, side, side, blk.conv1.weight.shape[1])),
                        jnp.bfloat16)
        bp = enc[f"layer{li}"][f"block{bi}"]

        def jblock(p, x):
            stats = {}
            return jr._bottleneck_apply(p, x, stride, dil, rest_dil, train, momentum,
                                        stats), stats

        j_out, j_stats = jax.jit(jblock).lower(bp, x).compile(compiler_options=NO_EXCESS)(bp, x)
        t_stats = {}
        t_out = blk(torch.from_numpy(_np(x)).bfloat16().permute(0, 3, 1, 2), stride, dil,
                    rest_dil, _bn_fn(train, t_stats, ""))
        check(f"layer{li}.{bi}", j_out, t_out.permute(0, 2, 3, 1),
              {"prefix": j_stats} if train else {}, t_stats)


def _bn_fn(train, stats, prefix):
    def bn(name, mod, h):
        if not train:
            return tr.batch_norm(mod, h)
        y, stats[prefix + name] = tr.batch_norm_train(mod, h)
        return y
    return bn


def test_resnet_bf16_forward_agrees_with_sod_tpu(resnet):
    jcfg, params, model = resnet
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 3)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    bparams = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    ref = jax.jit(lambda p, x: jmf.maskformer_apply(p, x, jcfg)).lower(bparams, xb).compile(
        compiler_options=NO_EXCESS)(bparams, xb)
    bmodel = _port(params, _tcfg(arch="resnet50")).to(torch.bfloat16)
    with torch.no_grad():
        out = bmodel(torch.from_numpy(x).bfloat16())
    assert out["mask_pred"].dtype == torch.float32
    diff = np.abs(_np(out["mask_pred"]) - _np(ref["mask_pred"]))
    assert diff.mean() <= 0.01, diff.mean()
    np.testing.assert_allclose(_np(out["objectness"]), _np(ref["objectness"]), atol=1e-3)


def test_canvas_forward_refuses_the_resnet(resnet):
    _, _, model = resnet
    z = torch.zeros(1, 8, 8, 3)
    with pytest.raises(ValueError, match="canvas path is for the ViT encoder"):
        tmf.maskformer_apply_canvas(model, z, torch.ones(1, 2, dtype=torch.bool),
                                    torch.zeros(1, 2, 384), torch.ones(1, 2, dtype=torch.int64))


def test_resnet_train_step_matches_sod_tpu(resnet):
    jcfg, params, _ = resnet
    model = _port(params, _tcfg(arch="resnet50"))
    cfg = Config(batch_size=2, lr=1e-3, lr_warmup_duration=0, n_epochs=2,
                 compute_dtype="float32", arch="resnet50", weight_decay=0.05)
    jm, tm, jnew, before, after = _steps(jcfg, params, model, cfg, _batch(5, 2))
    for k in METRIC_KEYS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-3, atol=1e-5, err_msg=k)
    # the BN buffers: the forward's EMA statistics, merged after the update
    buffers = [k for k in after if k.endswith(("running_mean", "running_var"))]
    assert len(buffers) == 106
    for k in buffers:
        assert not torch.equal(after[k], before[k]), k
        np.testing.assert_allclose(after[k].numpy(), jnew[k], rtol=0,
                                   atol=1e-4 * max(1.0, np.abs(jnew[k]).max()), err_msg=k)
    # the parameters: Adam's first step turns each gradient element into a
    # near-sign-sized update, so f32 noise in a small gradient flips its sign
    upd_t = np.concatenate([(after[k] - before[k]).numpy().ravel() for k in after
                            if k not in buffers])
    upd_j = np.concatenate([(jnew[k] - before[k].numpy()).ravel() for k in after
                            if k not in buffers])
    assert np.corrcoef(upd_t, upd_j)[0, 1] > 0.99
    assert (np.abs(upd_t - upd_j) <= 1e-5).mean() >= 0.97


def test_accumulated_step_merges_the_mean_of_the_micro_batches_statistics(resnet):
    """grad_accum_steps=2: the buffers after the step are the mean of the
    two micro-batches' train-mode statistics, taken from the weights before
    the step (sod_tpu/train/step.py:205-209)."""
    _, params, _ = resnet
    model = _port(params, _tcfg(arch="resnet50"))
    cfg = Config(batch_size=4, lr=1e-3, lr_warmup_duration=0, n_epochs=2,
                 compute_dtype="float32", arch="resnet50", grad_accum_steps=2)
    batch = {k: torch.from_numpy(v) for k, v in _batch(6, 4).items()}
    from sod_tpu_torch.data.augment import normalize_device

    x = normalize_device(batch["image"])
    with torch.no_grad():
        micro = [model(x[i:i + 2], train=True)["batch_stats"] for i in (0, 2)]
    step = make_train_step(cfg, model, build_optimizer(cfg, model.parameters(), 2),
                           accum_steps=2)
    step(batch)
    bns = dict(model.encoder.named_modules())
    for name in micro[0]:
        for s, buf in (("mean", "running_mean"), ("var", "running_var")):
            want = (micro[0][name][s] + micro[1][name][s]) / 2
            torch.testing.assert_close(getattr(bns[name], buf), want, rtol=1e-6, atol=1e-7)


