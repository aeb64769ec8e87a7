"""The port's model-sharding layouts on the CPU, ranks as processes over
gloo, against ``sod_tpu`` on its own meshes and on one device.

One 2-rank group runs TP (1x2), PP (1x2, M = 2 and 4) and SP (1x2, 17
tokens round a ring of 2, so one pad); one 4-rank group runs data x model
(2x2), p3 (1x2x2), sptp (1x2x2), TP at 1x4 (the 2 heads of d 32 cut in
half: q, k and v gathered; and a d 30 tree, whose attention stays whole
while its MLP shards) and a Trainer epoch under p3 whose ``.pt`` resumes
under sptp (and, in the parent, under no mesh).  ``zero1`` needs a
data axis above 1, so with four ranks it runs on the 2x2 mesh, on p3's mesh
with data 2 (2x2x1) and on sptp's (2x1x2).  Both groups run while the parent
computes ``sod_tpu``'s references on its virtual CPU devices
(``make_mesh_2d``, ``make_mesh_pp``, ``make_mesh_sp``, ``make_mesh_3d``,
``make_mesh_sptp``) and the one-device step, from the same numpy-drawn
trees.  The ranks import torch and the port only.

Model: ``tests/test_torch_data_parallel.py``'s tiny ViT (d 32, 2 heads,
depth 4, 4 queries, 32 px, f32, the plain attention path) and batches of 8.
Gradients are held to ``sod_tpu``'s one-device ones.  Tolerances are
``sod_tpu``'s own (``tests/test_tensor_parallel.py``,
``test_pipeline_parallel.py``, ``test_sequence_parallel.py``,
``test_3d_mesh.py``, ``test_sptp.py``): forwards rtol 1e-5 atol 1e-5 (the
ring's rtol 1e-4), gradients rtol 1e-3 atol 1e-6, the step's loss rtol 1e-5
and its parameters and moments atol 1e-5 rtol 1e-4, the Evaluator's metrics
rtol 1e-4 atol 1e-5.
"""
import functools
import os
import re
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sod_tpu_torch.config import Config
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.parallel import (make_mesh_2d, make_mesh_3d, make_mesh_pp, make_mesh_sp,
                                    make_mesh_sptp, p3_host_params, p3_merge_blocks,
                                    p3_split_blocks, pp_vit_apply, replicated, shard_batch,
                                    sp_vit_apply, sptp_vit_apply)
from sod_tpu_torch.parallel.comm import ppermute
from sod_tpu_torch.parallel.fsdp import model_merge, model_shard, reference_layout, stack_depths
from sod_tpu_torch.parallel.layouts import train_layout
from sod_tpu_torch.parallel.mesh import _rank_main, free_port
from sod_tpu_torch.parallel.p3 import p3_vit_apply
from sod_tpu_torch.parallel.tp import tp_vit_apply
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import make_train_step
from test_torch_data_parallel import _batches, _cfg, _mcfg, _trainer_cfg, _vit

FWD = dict(rtol=1e-5, atol=1e-5)
RING_FWD = dict(rtol=1e-4, atol=1e-5)
GRAD = dict(rtol=1e-3, atol=1e-6)
TOL = dict(atol=1e-5, rtol=1e-4)
EVAL = dict(rtol=1e-4, atol=1e-5)


def _token_mask(b=8, t=17, seed=4):
    mask = np.random.RandomState(seed).rand(b, t) > 0.3
    mask[:, 0] = True
    return mask


# ------------------------------------------------------------ the rank side

def _model(sd, mesh, cfg, mcfg=None):
    model = MaskFormer(mcfg or _mcfg())
    model.load_state_dict(sd)
    replicated(model, mesh)
    apply_fn, layout = train_layout(cfg, model.cfg, model, mesh)
    return model, apply_fn, layout


def _whole_grads(layout):
    """The encoder's gradients, whole: the parts summed over their axis and
    the shards merged."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in layout.params]
    for axis, idx in layout.partial.items():
        for i in idx:
            dist.all_reduce(grads[i], group=layout.mesh.get_group(axis))
    return {n: g.numpy().copy() for n, g in zip(layout.names, layout.mp_whole(grads))
            if n.startswith("encoder.")}


def _encoder_case(inp, mesh, fn, mask=None, sd="sd", mcfg=None, **kw):
    """The encoder's forward (every layer) and the gradients of the mean
    square of it, from the tiny tree's weights (``inp[sd]``, of ``mcfg``)."""
    sd = {k: torch.from_numpy(v) for k, v in inp[sd].items()}
    model, _, layout = _model(sd, mesh, _cfg(), mcfg)
    x = torch.from_numpy(inp["x"])
    m = None if mask is None else torch.from_numpy(mask)
    out = fn(model.encoder, x, mesh, all_layers=True, token_mask=m, **kw)
    out.square().mean().backward()
    return {"out": out.detach().numpy().copy(), "grads": _whole_grads(layout)}


def _step_case(inp, mesh, level="none"):
    """One train step from the tiny tree on this rank's rows: metrics, the
    whole parameters and moments after it, this rank's bytes."""
    sd = {k: torch.from_numpy(v) for k, v in inp["sd"].items()}
    cfg = _cfg(fsdp=level)
    model, apply_fn, layout = _model(sd, mesh, cfg)
    opt = build_optimizer(cfg, layout.tensors, n_iters_per_epoch=10)
    step = make_train_step(cfg, model, opt, layout=layout, apply_fn=apply_fn)
    b = {k: torch.from_numpy(v) for k, v in inp["batches"][0].items()}
    m = step(shard_batch(b, mesh))
    held = layout.bytes_per_rank(opt)
    model_state, opt_state = layout.full_state(opt)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.numpy() for k, v in model_state.items()},
            "mu": {n: t.numpy() for n, t in zip(layout.names, opt_state["mu"])},
            "nu": {n: t.numpy() for n, t in zip(layout.names, opt_state["nu"])},
            "bytes": held}


def _eval_case(inp, mesh):
    from sod_tpu_torch.train.evaluator import Evaluator

    model = MaskFormer(_mcfg(pos_grid=8, depth=2))
    model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["eval_sd"].items()})
    cfg = Config(dir_dataset=inp["eval_dir"], compute_dtype="float32",
                 use_pallas_attention=False, num_workers=0)
    return Evaluator(model, cfg, model.cfg, batch_size=4, device="cpu", mesh=mesh)("duts")


def _group2(inp, res):
    from sod_tpu_torch.train.trainer import Trainer

    mask = inp["mask"]
    mesh = make_mesh_2d(1, 2, "cpu")
    res["tp enc"] = _encoder_case(inp, mesh, tp_vit_apply)
    res["tp step"] = _step_case(inp, mesh)
    res["tp eval"] = _eval_case(inp, mesh)
    # ppermute's backward: the gradient goes back the other way round
    r = dist.get_rank()
    x = torch.full((3,), float(r + 1), requires_grad=True)
    (ppermute(x, mesh.get_group("model"), [(0, 1), (1, 0)]) * (r + 10)).sum().backward()
    res["ppermute grad"] = x.grad.clone()

    mesh = make_mesh_pp(1, 2, "cpu")
    for m in (2, 4):
        res[f"pp M{m} enc"] = _encoder_case(inp, mesh, pp_vit_apply, mask, n_micro=m)
    res["pp step"] = _step_case(inp, mesh)
    shown = []
    t = Trainer(_trainer_cfg(inp["train_dir"], suffix="pp"), device="cpu",
                state_dict={k: torch.from_numpy(v) for k, v in inp["sd"].items()},
                mcfg=_mcfg(), mesh=mesh,
                visualizer=lambda epoch, it, batch, outputs: shown.append(
                    (it, {k: v.shape for k, v in outputs.items()})))
    t._train_epoch(1)
    res["pp trainer"] = {"params": t._state()[0], "visualized": shown}

    mesh = make_mesh_sp(1, 2, "cpu")
    res["sp enc"] = _encoder_case(inp, mesh, sp_vit_apply, mask)
    res["sp step"] = _step_case(inp, mesh)
    res["sp eval"] = _eval_case(inp, mesh)


def _group4(inp, res):
    from sod_tpu_torch.train.trainer import Trainer

    mesh = make_mesh_2d(2, 2, "cpu")
    res["dtp zero1 step"] = _step_case(inp, mesh, "zero1")
    try:
        _step_case(inp, mesh, "full")
    except ValueError as e:
        res["full refused"] = str(e)
    mesh = make_mesh_3d(1, 2, 2, "cpu")
    res["p3 enc"] = _encoder_case(inp, mesh, p3_vit_apply, inp["mask"])
    res["p3 step"] = _step_case(inp, mesh)
    res["p3 zero1 step"] = _step_case(inp, make_mesh_3d(2, 2, 1, "cpu"), "zero1")
    mesh = make_mesh_sptp(1, 2, 2, "cpu")
    res["sptp enc"] = _encoder_case(inp, mesh, sptp_vit_apply, inp["mask"])
    res["sptp step"] = _step_case(inp, mesh)
    res["sptp eval"] = _eval_case(inp, mesh)
    res["sptp zero1 step"] = _step_case(inp, make_mesh_sptp(2, 1, 2, "cpu"), "zero1")
    # a model axis of 4 cuts the 2 heads of d 32 (q, k, v gathered); at d 30
    # attention stays whole and the MLP shards
    mesh = make_mesh_2d(1, 4, "cpu")
    res["tp4 enc"] = _encoder_case(inp, mesh, tp_vit_apply)
    res["tp4 d30 enc"] = _encoder_case(inp, mesh, tp_vit_apply, sd="sd30",
                                       mcfg=_mcfg30())
    res["tp4 step"] = _step_case(inp, mesh)
    res["tp4 eval"] = _eval_case(inp, mesh)

    # a Trainer epoch under p3 (the mesh from the config's axes), its .pt
    # resumed under sptp for a second epoch
    sd = {k: torch.from_numpy(v) for k, v in inp["sd"].items()}
    root = inp["train_dir"]
    t = Trainer(_trainer_cfg(root, suffix="p3", mesh_pipe_axis=2, mesh_model_axis=2),
                device="cpu", state_dict=sd, mcfg=_mcfg())
    res["p3 trainer mesh"] = tuple(t.mesh.mesh_dim_names), tuple(t.mesh.mesh.shape)
    res["p3 trainer qkv rows"] = [tuple(b.attn.qkv.weight.shape) for b in t.model.encoder.blocks]
    t._train_epoch(1)
    res["p3 trainer"] = {"params": t._state()[0], "path": t.latest_path}
    t = Trainer(_trainer_cfg(root, suffix="sptp", mesh_seq_axis=2, mesh_model_axis=2),
                device="cpu", mcfg=_mcfg())
    nxt = t.resume(res["p3 trainer"]["path"])
    t._train_epoch(nxt)
    res["sptp trainer resumed"] = {"next": nxt, "params": t._state()[0]}


def _mcfg30():
    return MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(**_vit30()))


def _vit30():
    return dict(_vit(), embed_dim=30)


def _group_cases(rank, tmp):
    torch.set_num_threads(1)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    res = {}
    (_group2 if os.environ["WORLD_SIZE"] == "2" else _group4)(inp, res)
    if rank == 0:
        torch.save(res, os.path.join(tmp, "ranks.pt"))


# ------------------------------------------------------------ the parent side

def _jax_refs(params, eval_params, x, mask, eval_dir, params30):
    """sod_tpu's encoder forwards on one device and on each layout's own
    mesh, its gradients on one device (its own tests hold its meshes'
    gradients to those), and its one-device Evaluator; the d 30 tree's
    forward and gradients on one device and its forward on (1, 4)."""
    import jax
    import jax.numpy as jnp

    from sod_tpu.config import Config as JaxConfig
    from sod_tpu.models.maskformer import MaskFormerConfig as JMC
    from sod_tpu.models.vit import ViTConfig as JViT, vit_apply
    from sod_tpu.parallel import (make_mesh_2d as jm2, make_mesh_3d as jm3, make_mesh_pp as jmpp,
                                  make_mesh_sp as jmsp, make_mesh_sptp as jmsptp,
                                  p3_vit_apply as jp3,
                                  pp_vit_apply as jpp, shard_params, shard_params_p3,
                                  shard_params_sptp, sp_vit_apply as jsp,
                                  sptp_vit_apply as jsptp)
    from sod_tpu.train.evaluator import Evaluator as JaxEvaluator
    from sod_tpu_torch.models.convert import vit_state_dict_from_jax

    cfg = JViT(**_vit())
    enc = params["encoder"]
    xj, mj = jnp.asarray(x), jnp.asarray(mask)

    def grads_of(fn, p):
        g = jax.device_get(jax.jit(jax.grad(lambda p_: jnp.mean(fn(p_) ** 2)))(p))
        return vit_state_dict_from_jax(g, "encoder.")

    def case(fn, p, grads=False):
        out = {"out": np.asarray(jax.jit(fn)(p))}
        if grads:
            out["grads"] = grads_of(fn, p)
        return out

    ref = {}
    ref["single"] = case(lambda p: vit_apply(p, xj, cfg, all_layers=True), enc, True)
    ref["single mask"] = case(lambda p: vit_apply(p, xj, cfg, all_layers=True,
                                                  token_mask=mj), enc, True)
    m2 = jm2(1, 2)
    tp_enc = shard_params(params, m2)["encoder"]
    with jax.set_mesh(m2):
        ref["tp"] = case(lambda p: vit_apply(p, xj, cfg, all_layers=True), tp_enc)
    cfg30 = JViT(**_vit30())
    ref["single d30"] = case(lambda p: vit_apply(p, xj, cfg30, all_layers=True),
                             params30["encoder"], True)
    m4 = jm2(1, 4)
    for name, c, p in (("tp4", cfg, params), ("tp4 d30", cfg30, params30)):
        with jax.set_mesh(m4):
            ref[name] = case(lambda p_, c=c: vit_apply(p_, xj, c, all_layers=True),
                             shard_params(p, m4)["encoder"])
    for m in (2, 4):
        mesh = jmpp(1, 2)
        ref[f"pp M{m}"] = case(lambda p: jpp(p, xj, cfg, mesh, n_micro=m, token_mask=mj), enc)
    ref["sp"] = case(lambda p: jsp(p, xj, cfg, jmsp(1, 2), token_mask=mj), enc)
    m3 = jm3(1, 2, 2)
    p3_enc = shard_params_p3(params, m3, cfg.depth)["encoder"]
    ref["p3"] = case(lambda p: jp3(p, xj, cfg, m3, token_mask=mj), p3_enc)
    ms = jmsptp(1, 2, 2)
    sptp_enc = shard_params_sptp(params, ms)["encoder"]
    ref["sptp"] = case(lambda p: jsptp(p, xj, cfg, ms, token_mask=mj), sptp_enc)
    ref["eval"] = JaxEvaluator(
        eval_params, JaxConfig(dir_dataset=eval_dir, compute_dtype="float32",
                               use_pallas_attention=False, num_workers=0),
        JMC(n_queries=4, n_decoder_layers=2, vit=JViT(**_vit(pos_grid=8, depth=2))),
        batch_size=4)("duts")
    return ref


def _start(n, tmp):
    return torch.multiprocessing.start_processes(
        _rank_main, args=(n, free_port(), _group_cases, (str(tmp),)), nprocs=n,
        join=False, start_method="spawn")


def _join(ctx):
    while not ctx.join():
        pass


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from sod_tpu.models.maskformer import MaskFormerConfig as JMC
    from sod_tpu.models.vit import ViTConfig as JViT
    from sod_tpu_torch.models.convert import state_dict_from_jax
    from sod_tpu_torch.train.trainer import Trainer
    from test_torch_data_parallel import _jax_run
    from test_torch_model_options import _jax_tree

    from tests._fixtures import make_duts

    tmp = tmp_path_factory.mktemp("mp")
    rng = np.random.RandomState(0)
    params = _jax_tree(JMC(n_queries=4, n_decoder_layers=2, vit=JViT(**_vit())), 0)
    eval_params = _jax_tree(JMC(n_queries=4, n_decoder_layers=2,
                                vit=JViT(**_vit(pos_grid=8, depth=2))), 1)
    sd = {k: np.array(v) for k, v in state_dict_from_jax(params).items()}
    params30 = _jax_tree(JMC(n_queries=4, n_decoder_layers=2, vit=JViT(**_vit30())), 5)
    batches = _batches(1)
    x = np.random.RandomState(3).rand(8, 32, 32, 3).astype(np.float32)
    mask = _token_mask()
    make_duts(tmp / "ev", rng, n_test=6, test_hw=(40, 48), variable_test=True)
    make_duts(tmp / "tr", rng, n_test=0, n_train=8, train_hw=(64, 64))
    inputs = {"sd": sd, "batches": batches, "x": x, "mask": mask,
              "eval_sd": state_dict_from_jax(eval_params), "eval_dir": str(tmp / "ev"),
              "train_dir": tmp / "tr",
              "sd30": {k: np.array(v) for k, v in state_dict_from_jax(params30).items()}}
    for n in (2, 4):
        os.makedirs(tmp / f"g{n}")
        torch.save(inputs, tmp / f"g{n}" / "inputs.pt")
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    groups = {n: _start(n, tmp / f"g{n}") for n in (2, 4)}
    if threads is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = threads

    # the parent's own torch work on two threads beside the ranks and jax
    parent_threads = torch.get_num_threads()
    torch.set_num_threads(2)
    pool = ThreadPoolExecutor(2)
    step_ref = pool.submit(_jax_run, params, batches)
    jax_ref = pool.submit(_jax_refs, params, eval_params, x, mask, str(tmp / "ev"), params30)
    # the port's one-device epochs: epoch 1, and epoch 2 resumed from its .pt
    t_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    single = Trainer(_trainer_cfg(tmp / "tr", suffix="single"), device="cpu",
                     state_dict=t_sd, mcfg=_mcfg())
    single._train_epoch(1)
    ref = {"trainer single": {k: v.clone() for k, v in single.model.state_dict().items()}}
    single2 = Trainer(_trainer_cfg(tmp / "tr", suffix="single2"), device="cpu", mcfg=_mcfg())
    single2._train_epoch(single2.resume(single.latest_path))
    ref["trainer single resumed"] = single2.model.state_dict()
    ref["step"] = step_ref.result()
    ref.update(jax_ref.result())
    pool.shutdown()
    for ctx in groups.values():
        _join(ctx)
    out = {n: torch.load(tmp / f"g{n}" / "ranks.pt", weights_only=False) for n in (2, 4)}
    # the p3 .pt resumed with no mesh
    t = Trainer(_trainer_cfg(tmp / "tr", suffix="nomesh"), device="cpu", mcfg=_mcfg())
    nxt = t.resume(out[4]["p3 trainer"]["path"])
    t._train_epoch(nxt)
    ref["no mesh resumed"] = {"next": nxt, "params": t.model.state_dict()}
    torch.set_num_threads(parent_threads)
    return {**out[2], **out[4], "ref": ref}


# ------------------------------------------------------------ forwards, gradients

ENCODERS = [("tp enc", "tp", "single", FWD), ("tp4 enc", "tp4", "single", FWD),
            ("tp4 d30 enc", "tp4 d30", "single d30", FWD),
            ("pp M2 enc", "pp M2", "single mask", FWD),
            ("pp M4 enc", "pp M4", "single mask", FWD), ("sp enc", "sp", "single mask", RING_FWD),
            ("p3 enc", "p3", "single mask", FWD), ("sptp enc", "sptp", "single mask", RING_FWD)]


@pytest.mark.parametrize("got,mesh_ref,single_ref,tol", ENCODERS,
                         ids=[e[0].replace(" enc", "") for e in ENCODERS])
def test_encoder_forward_equals_sod_tpus(runs, got, mesh_ref, single_ref, tol):
    """Every layer's normed tokens [L, B, 17, D] against sod_tpu's on its
    own mesh and on one device (PP, SP, p3, sptp with a token mask; TP at
    model 4 with cut heads at d 32, and with attention whole and the MLP
    sharded at d 30)."""
    out = runs[got]["out"]
    assert out.shape == (4, 8, 17, 30 if "d30" in got else 32)
    for ref in (mesh_ref, single_ref):
        np.testing.assert_allclose(out, runs["ref"][ref]["out"], err_msg=ref, **tol)


@pytest.mark.parametrize("got,mesh_ref,single_ref,tol", ENCODERS,
                         ids=[e[0].replace(" enc", "") for e in ENCODERS])
def test_encoder_gradients_equal_sod_tpus(runs, got, mesh_ref, single_ref, tol):
    """The gradients of the mean square of every layer, each rank's parts
    summed and shards merged back to whole packed leaves, against
    sod_tpu's one-device gradients (which its own tests hold its meshes'
    gradients to, within the same tolerance)."""
    grads, want = runs[got]["grads"], runs["ref"][single_ref]["grads"]
    assert set(want) == set(grads)
    for k, w in want.items():
        np.testing.assert_allclose(grads[k], w, err_msg=f"{single_ref} {k}", **GRAD)


# ------------------------------------------------------------ the train step

STEPS = ["tp", "tp4", "pp", "sp", "dtp zero1", "p3", "p3 zero1", "sptp", "sptp zero1"]


@pytest.mark.parametrize("name", STEPS)
def test_train_step_equals_sod_tpus_one_device_step(runs, name):
    """One step of batch 8 under each layout (its rows on each data rank)
    against sod_tpu's one-device step: loss and metrics, the whole packed
    parameters and both AdamW moments."""
    got, want = runs[f"{name} step"], runs["ref"]["step"]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    for k in ("grad_norm", "iou", "contrastive_loss", "dice_loss"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert got["metrics"]["grad_norm"] > 10.0          # the clip binds
    for key in ("params", "mu", "nu"):
        for n, w in want[key].items():
            np.testing.assert_allclose(got[key][n], w, err_msg=f"{key} {n}", **TOL)


def test_each_rank_holds_its_shards(runs):
    """Bytes a rank holds after the step: TP half of each Megatron leaf, PP
    half the blocks, SP everything; zero1 on the 2x2 mesh the TP shards and
    fewer moments; no rank keeps a gradient."""
    from sod_tpu_torch.parallel import tp_specs

    params = runs["sp step"]["params"]
    size = {k: v.size * 4 for k, v in params.items()}
    megatron = [k for k, s in tp_specs(_port_model(), 2).items() if s]
    blocks = [k for k in size if k.startswith("encoder.blocks.")]
    whole = runs["sp step"]["bytes"]
    assert whole == {"weights": sum(size.values()), "moments": 2 * sum(size.values()),
                     "grads": 0}
    for name, halved in (("tp", megatron), ("pp", blocks)):
        got = runs[f"{name} step"]["bytes"]
        w = whole["weights"] - sum(size[k] for k in halved) // 2
        assert got == {"weights": w, "moments": 2 * w, "grads": 0}, name
    dtp, tp = runs["dtp zero1 step"]["bytes"], runs["tp step"]["bytes"]
    assert dtp["weights"] == tp["weights"] and dtp["moments"] < tp["moments"]


def test_full_is_refused_with_a_model_axis(runs):
    assert runs["full refused"] == (
        "fsdp='full' is mutually exclusive with the ['model'] mesh axes — TP/PP shard "
        "the stored weights on their own axes; use fsdp='zero1' to shard the moments "
        "on top (see parallel/fsdp.py docstring)")


# ------------------------------------------------------------ the Evaluator

@pytest.mark.parametrize("name", ["tp", "tp4", "sp", "sptp"])
def test_evaluator_equals_sod_tpus(runs, name):
    """6 canvas images at batch 4 under TP (model 2, and model 4 cutting the
    2 heads), SP (the canvas tokens round the ring with their key masks) and
    sptp against sod_tpu's Evaluator."""
    got, want = runs[f"{name} eval"], runs["ref"]["eval"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **EVAL)


# ------------------------------------------------------------ the Trainer

def test_trainer_p3_epoch_resumes_under_sptp_and_no_mesh(runs):
    """The config's pipe and model axes make the 1x2x2 mesh; its epoch
    equals the one-device epoch; its ``.pt`` (the whole packed state) resumes
    under sptp and under no mesh, each second epoch equal to the one-device
    resumed epoch."""
    assert runs["p3 trainer mesh"] == (("data", "pipe", "model"), (1, 2, 2))
    rows = runs["p3 trainer qkv rows"]
    assert rows[:2] == [(48, 32)] * 2 or rows[2:] == [(48, 32)] * 2
    assert (0,) in rows
    for k, v in runs["ref"]["trainer single"].items():
        np.testing.assert_allclose(runs["p3 trainer"]["params"][k].numpy(), v.numpy(),
                                   err_msg=k, **TOL)
    for got in (runs["sptp trainer resumed"], runs["ref"]["no mesh resumed"]):
        assert got["next"] == 2
        for k, v in runs["ref"]["trainer single resumed"].items():
            np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=k, **TOL)


def test_pp_trainer_vis_step_uses_stage_forward(runs):
    """The visualizer hook under a pipe mesh runs the step's own forward on
    the rank's whole batch (GPipe cannot take one image), then shows the
    first image; the epoch equals the one-device epoch."""
    got = runs["pp trainer"]
    assert got["visualized"] == [(0, {"mask_pred": (1, 4, 16, 16), "objectness": (1, 4)}),
                                 (1, {"mask_pred": (1, 4, 16, 16), "objectness": (1, 4)})]
    for k, v in runs["ref"]["trainer single"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=k, **TOL)


def test_ppermute_backward_sends_the_gradient_back(runs):
    """Rank r sends r + 1 to the other rank, whose loss weighs it by its own
    rank + 10: each rank's gradient is the other rank's weight."""
    assert torch.equal(runs["ppermute grad"], torch.full((3,), 11.0))


# ------------------------------------------------------------ single process

class _Mesh:
    """A mesh's axis names and sizes, for the pure rules."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self.sizes = list(sizes.values())

    def size(self, dim=0):
        return self.sizes[dim]

    def get_local_rank(self, axis):
        return 0


def _port_model(**vit):
    m = MaskFormer(_mcfg(**vit))
    for p in m.parameters():
        torch.nn.init.normal_(p)
    return m


@functools.lru_cache(maxsize=None)
def _jax_params():
    from sod_tpu.models.maskformer import MaskFormerConfig as JMC
    from sod_tpu.models.vit import ViTConfig as JViT
    from test_torch_model_options import _jax_tree

    return _jax_tree(JMC(n_queries=4, n_decoder_layers=2, vit=JViT(**_vit())), 0)


def _specs_by_name(jax_params, jax_specs, to_state_dict):
    """sod_tpu's spec of every port name: each leaf filled with its index
    and converted, so the port name reads the leaf it came from."""
    import jax
    from jax.sharding import PartitionSpec as P

    leaves = jax.tree.leaves(jax_specs, is_leaf=lambda s: isinstance(s, P))
    idx = jax.tree.map(lambda leaf, i: np.full(leaf.shape, i, np.int64), jax_params,
                       jax.tree.unflatten(jax.tree.structure(jax_params),
                                          list(range(len(leaves)))))
    out = {}
    for name, arr in to_state_dict(idx).items():
        spec = tuple(leaves[int(np.asarray(arr).reshape(-1)[0])])
        out[name] = spec
    return out


def _padded(spec, n):
    return tuple(spec) + (None,) * (n - len(tuple(spec)))


def _compare(ours, theirs, shapes, depths):
    for name, spec in ours.items():
        ref, _ = reference_layout(name, shapes[name], depths)
        assert _padded(theirs[name], len(ref)) == spec, name


def _as_ref(port_specs, shapes):
    depths = stack_depths(shapes)
    out = {}
    for name, spec in port_specs.items():
        ref, axes = reference_layout(name, shapes[name], depths)
        ent = [None] * len(ref)
        for axis, d in spec.items():
            ent[axes.index(d)] = axis
        out[name] = tuple(ent)
    return out, depths


@pytest.mark.parametrize("n_model", [2, 4, 5])
def test_tp_specs_equal_sod_tpus(n_model):
    """The same leaves shard, on the same axis of sod_tpu's leaf (stacked,
    (in, out)), at model sizes 2, 4 and 5 (5 divides nothing: all whole)."""
    from sod_tpu.parallel import tp_specs as jtp_specs
    from sod_tpu_torch.models.convert import state_dict_from_jax
    from sod_tpu_torch.parallel import tp_specs

    model, params = _port_model(), _jax_params()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ours, depths = _as_ref(tp_specs(model, n_model), shapes)
    theirs = _specs_by_name(params, jtp_specs(params, n_model), state_dict_from_jax)
    _compare(ours, theirs, shapes, depths)
    assert any(a for spec in ours.values() for a in spec) == (n_model != 5)


@pytest.mark.parametrize("n_pipe", [2, 4, 3])
def test_pp_specs_equal_sod_tpus(n_pipe):
    from sod_tpu.parallel import pp_specs as jpp_specs
    from sod_tpu_torch.models.convert import state_dict_from_jax
    from sod_tpu_torch.parallel import pp_specs

    model, params = _port_model(), _jax_params()
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ours, depths = _as_ref(pp_specs(model, n_pipe, 4), shapes)
    theirs = _specs_by_name(params, jpp_specs(params, n_pipe, 4), state_dict_from_jax)
    _compare(ours, theirs, shapes, depths)


@pytest.mark.parametrize("which", ["p3", "sptp"])
def test_split_block_specs_equal_sod_tpus(which):
    """``p3_block_specs`` / ``sptp_block_specs`` of the split layout, leaf
    for leaf against sod_tpu's on its split stack."""
    from sod_tpu.parallel import p3_split_blocks as jsplit
    from sod_tpu.parallel.p3 import p3_block_specs as jp3
    from sod_tpu.parallel.sptp import sptp_block_specs as jsptp
    from sod_tpu_torch.models.convert import vit_blocks_from_jax
    from sod_tpu_torch.parallel.p3 import p3_block_specs
    from sod_tpu_torch.parallel.sptp import sptp_block_specs

    model, params = _port_model(), _jax_params()
    split = p3_split_blocks({n: p for n, p in model.named_parameters()
                             if n.startswith("encoder.blocks.")})
    shapes = {k: tuple(v.shape) for k, v in split.items()}
    ours, depths = _as_ref((p3_block_specs if which == "p3" else sptp_block_specs)(split),
                           shapes)
    jblocks = jsplit(params["encoder"]["blocks"])
    jspecs = (jp3 if which == "p3" else jsptp)(jblocks)

    def to_sd(tree):
        """The split tree's port names: q, k and v one at a time through the
        packed converter's qkv slot."""
        out = {}
        for n in "qkv":
            conv = vit_blocks_from_jax({**tree, "attn": {"qkv": tree["attn"][n],
                                                         "proj": tree["attn"]["proj"]}},
                                       "encoder.blocks.")
            out.update({k.replace(".attn.qkv.", f".attn.{n}."): v for k, v in conv.items()})
        return out

    theirs = _specs_by_name(jblocks, jspecs, to_sd)
    assert set(theirs) == set(ours)
    _compare(ours, theirs, shapes, depths)
    assert ours["encoder.blocks.0.attn.q.weight"] == (
        ("pipe", None, "model") if which == "p3" else (None, None, "model"))


def test_zero1_moments_over_tp_equal_sod_tpus():
    """``opt_state_shardings`` under zero1 on a 2x2 (data, model) mesh: each
    moment keeps its weight's model axis and adds ``data`` where sod_tpu's
    ``zero1_moment_shardings`` adds it on the TP-sharded tree (some moments
    on both axes)."""
    import jax

    from sod_tpu.parallel import (make_mesh_2d as jm2, shard_params as jshard,
                                  zero1_moment_shardings as jz1)
    from sod_tpu_torch.models.convert import state_dict_from_jax
    from sod_tpu_torch.parallel import opt_state_shardings

    model, params = _port_model(), _jax_params()
    mesh = jm2(2, 2)
    theirs = _specs_by_name(params, jax.tree.map(lambda sh: sh.spec,
                                                  jz1(jshard(params, mesh), mesh)),
                            state_dict_from_jax)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    ours, depths = _as_ref(opt_state_shardings(model, _Mesh(data=2, model=2), level="zero1"),
                           shapes)
    _compare(ours, theirs, shapes, depths)
    assert any({"data", "model"} <= set(spec) for spec in ours.values())


@pytest.mark.parametrize("bias", [True, False])
def test_split_then_merge_is_the_identity(bias):
    model = _port_model()
    state = {k: v for k, v in model.state_dict().items() if bias or not k.endswith("qkv.bias")}
    split = p3_split_blocks(state)
    assert not any(".attn.qkv." in k for k in split)
    assert split["encoder.blocks.1.attn.k.weight"].shape == (32, 32)
    assert ("encoder.blocks.1.attn.k.bias" in split) == bias
    merged = p3_merge_blocks(split)
    assert list(merged) == list(state)
    assert all(torch.equal(merged[k], state[k]) for k in state)
    host = p3_host_params(split)                       # the packed host copy
    assert list(host) == list(state) and all(torch.equal(host[k], state[k]) for k in state)


@pytest.mark.parametrize("name", ["encoder.blocks.0.attn.qkv.weight",
                                  "encoder.blocks.0.attn.qkv.bias",
                                  "decoder.layers.0.self_attn.in_proj_weight",
                                  "decoder.layers.1.multihead_attn.in_proj_bias"])
def test_packed_shards_hold_whole_heads(name):
    """A model shard of a packed leaf is its rank's rows of q, of k and of v
    (a head group of each); merging every rank's gives the leaf back."""
    t = dict(_port_model().named_parameters())[name].detach()
    d = t.shape[0] // 3
    for n in (1, 2):
        parts = [model_shard(t, 0, n, r, True) for r in range(n)]
        for r, part in enumerate(parts):
            c = d // n
            want = torch.cat([t[i * d + r * c:i * d + (r + 1) * c] for i in range(3)])
            assert torch.equal(part, want)
        assert torch.equal(model_merge(parts, 0, True), t)


def test_ring_absorb_of_two_slices_equals_dense_attention():
    """Two query slices, each absorbing both key/value slices in turn (the
    ring's arithmetic without its collectives), with masked keys (-1e30, a
    slice's keys all masked included), equal the dense softmax."""
    from sod_tpu_torch.ops.attention import sdpa
    from sod_tpu_torch.parallel.sp import absorb

    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, 10, 8, generator=g) for _ in range(3))
    mask = torch.rand(2, 10, generator=g) > 0.3
    mask[:, 0] = True
    mask[1, 5:] = False
    dense = sdpa(q, k, v, 8 ** -0.5, mask)
    for j in range(2):
        qs = q[:, :, 5 * j:5 * (j + 1)]
        m = torch.full(qs.shape[:3], -1e30)
        l, acc = torch.zeros(qs.shape[:3]), torch.zeros(qs.shape)
        for i in range(2):
            src = (j - i) % 2
            sl = slice(5 * src, 5 * (src + 1))
            m, l, acc = absorb(qs, m, l, acc, k[:, :, sl], v[:, :, sl], mask[:, sl], 8 ** -0.5)
        np.testing.assert_allclose((acc / l[..., None]).numpy(),
                                   dense[:, :, 5 * j:5 * (j + 1)].numpy(), **RING_FWD)


@functools.lru_cache(maxsize=None)
def _errors():
    """(port call, sod_tpu call) pairs that must raise alike."""
    import jax.numpy as jnp

    from sod_tpu.models.vit import ViTConfig as JViT
    from sod_tpu import parallel as jp
    from sod_tpu_torch import parallel as tp_

    cfg = Config(use_pallas_attention=False)
    jcfg = JViT(**_vit())
    port = _port_model()
    x8 = torch.zeros(8, 32, 32, 3)
    xj = jnp.zeros((8, 32, 32, 3))
    jparams = _jax_params()["encoder"]
    deep = ViTConfig(**_vit(depth=3))
    odd = ViTConfig(patch_size=8, embed_dim=24, depth=4, n_heads=6, pos_grid=4)
    jodd = JViT(patch_size=8, embed_dim=24, depth=4, n_heads=6, pos_grid=4, mlp_ratio=2)
    flash = ViTConfig(**_vit(), use_flash=True)
    jflash = JViT(**_vit(), use_flash=True)
    enc = port.encoder
    flash_enc = MaskFormer(_mcfg()).encoder
    flash_enc.cfg = flash
    deep_enc = MaskFormer(MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=deep)).encoder
    return {
        "n_model < 1": (lambda: make_mesh_2d(1, 0, "cpu"), lambda: jp.make_mesh_2d(1, 0)),
        "n_pipe/n_model < 1": (lambda: make_mesh_3d(1, 0, 2, "cpu"),
                               lambda: jp.make_mesh_3d(1, 0, 2)),
        "tp fused": (lambda: tp_.assert_tp_compatible(Config(use_fused_mlp=True),
                                                      _Mesh(data=1, model=2)),
                     lambda: jp.assert_tp_compatible(Config(use_fused_mlp=True),
                                                     jp.make_mesh_2d(1, 2))),
        "pp fused": (lambda: tp_.assert_pp_compatible(Config(use_fused_mlp=True),
                                                      _Mesh(data=1, pipe=4), 4),
                     lambda: jp.assert_pp_compatible(Config(use_fused_mlp=True),
                                                     jp.make_mesh_pp(1, 4), 4)),
        "sp fused": (lambda: tp_.assert_sp_compatible(Config(use_fused_mlp=True),
                                                      _Mesh(data=1, seq=4)),
                     lambda: jp.assert_sp_compatible(Config(use_fused_mlp=True),
                                                     jp.make_mesh_sp(1, 4))),
        "p3 heads": (lambda: tp_.assert_p3_compatible(cfg, _Mesh(data=1, pipe=2, model=4), odd),
                     lambda: jp.assert_p3_compatible(cfg, jp.make_mesh_3d(1, 2, 4), jodd)),
        "p3 depth": (lambda: tp_.assert_p3_compatible(cfg, _Mesh(data=2, pipe=2, model=2),
                                                      ViTConfig(**dict(_vit(depth=3), n_heads=4))),
                     lambda: jp.assert_p3_compatible(cfg, jp.make_mesh_3d(2, 2, 2),
                                                     JViT(**dict(_vit(depth=3), n_heads=4)))),
        "sptp heads": (lambda: tp_.assert_sptp_compatible(cfg, _Mesh(data=1, seq=2, model=4),
                                                          odd),
                       lambda: jp.assert_sptp_compatible(cfg, jp.make_mesh_sptp(1, 2, 4), jodd)),
        "pp n_micro": (lambda: pp_vit_apply(enc, x8, _Mesh(data=1, pipe=4), n_micro=3),
                       lambda: jp.pp_vit_apply(jparams, xj, jcfg, jp.make_mesh_pp(1, 4),
                                               n_micro=3)),
        "pp depth": (lambda: pp_vit_apply(deep_enc, x8, _Mesh(data=1, pipe=4)),
                     lambda: jp.pp_vit_apply(jparams, xj, JViT(**_vit(depth=3)),
                                             jp.make_mesh_pp(1, 4))),
        "pp micro-batch": (lambda: pp_vit_apply(enc, x8[:2], _Mesh(data=4, pipe=2), n_micro=4),
                           lambda: jp.pp_vit_apply(jparams, xj, jcfg, jp.make_mesh_pp(4, 2),
                                                   n_micro=4)),
        "pp flash": (lambda: pp_vit_apply(flash_enc, x8, _Mesh(data=1, pipe=4)),
                     lambda: jp.pp_vit_apply(jparams, xj, jflash, jp.make_mesh_pp(1, 4))),
        "sp flash": (lambda: sp_vit_apply(flash_enc, x8, _Mesh(data=1, seq=4)),
                     lambda: jp.sp_vit_apply(jparams, xj, jflash, jp.make_mesh_sp(1, 4))),
        "p3 packed": (lambda: p3_vit_apply(enc, x8, _Mesh(data=2, pipe=2, model=2)),
                      lambda: jp.p3_vit_apply(jparams, xj, jcfg, jp.make_mesh_3d(2, 2, 2))),
        "sptp packed": (lambda: sptp_vit_apply(enc, x8, _Mesh(data=2, seq=2, model=2)),
                        lambda: jp.sptp_vit_apply(jparams, xj, jcfg,
                                                  jp.make_mesh_sptp(2, 2, 2))),
        "full with a model axis": (
            lambda: tp_.assert_fsdp_compatible(Config(fsdp="full"), _Mesh(data=2, model=2)),
            lambda: jp.assert_fsdp_compatible(Config(fsdp="full"), jp.make_mesh_2d(2, 2))),
    }


ERRORS = ["n_model < 1", "n_pipe/n_model < 1", "tp fused", "pp fused", "sp fused", "p3 heads",
          "p3 depth", "sptp heads", "pp n_micro", "pp depth", "pp micro-batch", "pp flash",
          "sp flash", "p3 packed", "sptp packed", "full with a model axis"]


@pytest.mark.parametrize("case", ERRORS)
def test_validation_errors_are_sod_tpus(case):
    """Each check raises sod_tpu's type with sod_tpu's message."""
    port, ref = _errors()[case]
    with pytest.raises(ValueError) as want:
        ref()
    with pytest.raises(ValueError) as got:
        port()
    assert str(got.value) == str(want.value)


def test_mesh_beyond_the_devices_raises_before_any_rendezvous():
    from sod_tpu_torch.parallel.mesh import device_limit

    have = device_limit("cpu")
    for fn, dims in ((lambda: make_mesh_2d(have, 2, "cpu"), f"{have}x2"),
                     (lambda: make_mesh_pp(have, 2, "cpu"), f"{have}x2"),
                     (lambda: make_mesh_sp(have, 2, "cpu"), f"{have}x2"),
                     (lambda: make_mesh_3d(have, 2, 2, "cpu"), f"{have}x2x2"),
                     (lambda: make_mesh_sptp(have, 2, 2, "cpu"), f"{have}x2x2")):
        with pytest.raises(ValueError, match=re.escape(f"requested {dims} devices, have {have}")):
            fn()
    assert not dist.is_initialized()
