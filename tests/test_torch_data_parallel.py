"""The port's data-parallel layouts on the CPU, ranks as processes over gloo,
against ``sod_tpu`` on ``make_mesh(2)`` / ``make_mesh(4)`` and on one device.

One 2-rank group runs every case and hands its results to the parent; one
4-rank group runs the ZeRO-1 step; one ``cli.generate_masks --n_devices 2``
spawns its own two ranks.  All three run while the parent computes
``sod_tpu``'s references.  The ranks import torch and the port only: this
module imports ``sod_tpu`` (and so jax) inside the parent-side code.

Model: ``tests/test_fsdp.py``'s tiny ViT (d 32, depth 4 so that the MLP
leaves reach ``MIN_SHARD_SIZE`` and ZeRO-1 / FSDP-full really shard), 2
heads, 4 queries, 32 px, f32, the plain attention path; weights are sod_tpu
trees drawn with numpy (``tests/test_torch_model_options.py``'s
``_jax_tree``).  Batches of 8 with labels ``[0, 1, 2, 3] * 2``: every
contrastive positive pair has one image on each rank of two; image 5 has no
valid mask.  The gradient norm is ~260, so the clip at 1.0 binds.  Tolerances are ``sod_tpu``'s own
(``tests/test_fsdp.py``, ``tests/test_parallel.py``): loss rtol 1e-5,
parameters and AdamW moments atol 1e-5 rtol 1e-4, evaluator metrics rtol
1e-4 atol 1e-5.
"""
import json
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from sod_tpu_torch.config import Config
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, random_state_dict
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.parallel import make_mesh, replicated, shard_batch
from sod_tpu_torch.parallel.fsdp import StateLayout, assert_fsdp_compatible
from sod_tpu_torch.parallel.mesh import (_rank_main, batch_sharding, data_size, free_port,
                                         gather_rows)
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import make_train_step

B = 8
LEVELS = ("none", "zero1", "full")
TOL = dict(atol=1e-5, rtol=1e-4)


def _vit(pos_grid=4, depth=4):
    return dict(patch_size=8, embed_dim=32, depth=depth, n_heads=2, pos_grid=pos_grid)


def _mcfg(arch="vit_small", **vit):
    return MaskFormerConfig(n_queries=4, n_decoder_layers=2, arch=arch,
                            vit=ViTConfig(**_vit(**vit)))


def _cfg(**kw):
    return Config(batch_size=B, compute_dtype="float32", use_pallas_attention=False,
                  max_gt_masks=2, **kw)


def _batches(n=2, b=B, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        valid = np.ones((b, 2), bool)
        valid[5 % b] = False
        out.append({"image": rng.rand(b, 32, 32, 3).astype(np.float32),
                    "gt_masks": (rng.rand(b, 2, 32, 32) > 0.5).astype(np.float32),
                    "gt_valid": valid, "labels": np.tile(np.arange(b // 2), 2)})
    return out


def _trainer_cfg(root, **kw):
    return Config(dir_dataset=str(root), pseudo_masks_fp=str(root / "pseudo.json"),
                  train_image_size=64, batch_size=4, compute_dtype="float32",
                  use_pallas_attention=False, max_gt_masks=2, num_workers=0,
                  dir_ckpt=str(root / "ckpt"), n_epochs=2, **kw)


# ------------------------------------------------------------ the rank side

def _steps(cfg, mcfg, sd, batches, mesh, level="none", accum=1, mode="averaged"):
    """Train steps from ``sd`` on this rank's rows: the metrics of the last,
    the whole parameters and moments after it (every rank's), and the bytes
    this rank holds."""
    model = MaskFormer(mcfg)
    model.load_state_dict(sd)
    replicated(model, mesh)
    layout = StateLayout(model, mesh, level)
    opt = build_optimizer(cfg, layout.tensors, n_iters_per_epoch=10)
    step = make_train_step(cfg, model, opt, accum, mode, layout=layout)
    for b in batches:
        m = step(shard_batch({k: torch.from_numpy(v) for k, v in b.items()}, mesh, accum))
    held = layout.bytes_per_rank(opt)
    model_state, opt_state = layout.full_state(opt)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": {k: v.numpy() for k, v in model_state.items()},
            "mu": {n: t.numpy() for n, t in zip(layout.names, opt_state["mu"])},
            "nu": {n: t.numpy() for n, t in zip(layout.names, opt_state["nu"])},
            "bytes": held, "sharded": [layout.names[i] for i in layout.sharded]}


def _group_cases(rank, tmp):
    torch.set_num_threads(2)
    inp = torch.load(os.path.join(tmp, "inputs.pt"), weights_only=False)
    n = inp["n"]
    mesh = make_mesh(n, "cpu")
    sd = {k: torch.from_numpy(v) for k, v in inp["sd"].items()}
    mcfg, batches, res = _mcfg(), inp["batches"], {}
    if n == 4:
        res["zero1"] = _steps(_cfg(fsdp="zero1"), mcfg, sd, batches[:1], mesh, "zero1")
    else:
        for level in LEVELS:
            res[level] = _steps(_cfg(fsdp=level), mcfg, sd, batches, mesh, level)
        res["zero1 averaged"] = _steps(_cfg(fsdp="zero1"), mcfg, sd, batches[:1], mesh,
                                       "zero1", accum=2)
        res["zero1 exact"] = _steps(_cfg(fsdp="zero1"), mcfg, sd, batches[:1], mesh,
                                    "zero1", accum=2, mode="exact")
        rn_sd = {k: torch.from_numpy(v) for k, v in inp["resnet_sd"].items()}
        res["resnet50"] = _steps(_cfg(arch="resnet50"), _mcfg("resnet50"), rn_sd,
                                 inp["resnet_batches"], mesh)
        res.update(_other_cases(rank, tmp, inp, mesh, sd))
    if rank == 0:
        torch.save(res, os.path.join(tmp, f"ranks{n}.pt"))


def _other_cases(rank, tmp, inp, mesh, sd):
    from sod_tpu_torch.data.loader import DataLoader
    from sod_tpu_torch.train.evaluator import Evaluator
    from sod_tpu_torch.train.trainer import Trainer

    res = {}
    # the same weights on every rank from different seeds: rank 0's
    model = MaskFormer(_mcfg())
    model.load_state_dict(random_state_dict(model, 100 + rank))
    replicated(model, mesh)
    res["replicated"] = {k: v.clone() for k, v in model.state_dict().items()}

    # the Evaluator: 6 images at batch 4 (the last batch ragged: rank 1's
    # rows of it are all padding)
    ev_model = MaskFormer(_mcfg(pos_grid=8, depth=2))
    ev_model.load_state_dict({k: torch.from_numpy(v) for k, v in inp["eval_sd"].items()})
    ev_cfg = Config(dir_dataset=inp["eval_dir"], compute_dtype="float32",
                    use_pallas_attention=False, num_workers=2)
    ev = Evaluator(ev_model, ev_cfg, ev_model.cfg, batch_size=4, device="cpu", mesh=mesh)
    res["evaluator"] = ev("duts", dir_ckpt=os.path.join(tmp, "ev_csv"))
    try:
        ev("duts", batch_size=3)
    except ValueError as e:
        res["evaluator indivisible"] = str(e)

    # the loaders: this rank's rows through forked workers (after the
    # process group is up), and sod_tpu's shard_by_process stride
    class Rows:
        def __len__(self):
            return 11

        def __getitem__(self, i):
            return {"i": int(i), "cuda": torch.cuda.is_initialized()}
    rows = batch_sharding(mesh, 4)
    for procs in (False, True):
        loader = DataLoader(Rows(), batch_size=4, shuffle=True, seed=3, rows=rows,
                            use_processes=procs, num_workers=2)
        loader.set_epoch(1)
        res[f"rows procs={procs}"] = [[s["i"] for s in b] for b in loader]
        res[f"cuda in workers={procs}"] = any(s["cuda"] for b in loader for s in b)
    loader = DataLoader(Rows(), batch_size=2, shuffle=True, seed=3, shard_by_process=True)
    loader.set_epoch(1)
    res["shard_by_process"] = ([[s["i"] for s in b] for b in loader], len(loader))

    # errors
    for name, fn in (
            ("indivisible batch", lambda: shard_batch({"x": torch.zeros(3)}, mesh)),
            ("full with a kernel flag",
             lambda: assert_fsdp_compatible(Config(fsdp="full", use_fused_train=True), mesh))):
        try:
            fn()
        except ValueError as e:
            res[name] = str(e)

    # the gather's backward: each rank's own rows
    x = torch.full((2, 3), float(rank + 1), requires_grad=True)
    (gather_rows(x, mesh) * torch.arange(4.)[:, None]).sum().backward()
    res["gather grad"] = x.grad.clone()

    # the Trainer: one epoch under fsdp full; zero1 resumed from the
    # single-device checkpoint for a second epoch
    root = inp["train_dir"]
    shown = []
    t = Trainer(_trainer_cfg(root, suffix="full", fsdp="full"), device="cpu",
                state_dict=sd, mcfg=_mcfg(), mesh=mesh,
                visualizer=lambda epoch, it, batch, outputs: shown.append(
                    (it, {k: v.shape for k, v in outputs.items()})))
    held = t.layout.bytes_per_rank(t.optimizer)
    t._train_epoch(1)
    res["trainer full"] = {"params": t._state()[0], "bytes": held, "path": t.latest_path,
                           "visualized": shown}
    t = Trainer(_trainer_cfg(root, suffix="zero1", fsdp="zero1"), device="cpu",
                state_dict=sd, mcfg=_mcfg(), mesh=mesh)
    nxt = t.resume(inp["single_ckpt"])
    t._train_epoch(nxt)
    res["trainer zero1 resumed"] = {"next": nxt, "params": t._state()[0]}
    return res


# ------------------------------------------------------------ the parent side

def _start(n, tmp):
    return torch.multiprocessing.start_processes(
        _rank_main, args=(n, free_port(), _group_cases, (str(tmp),)), nprocs=n,
        join=False, start_method="spawn")


def _join(ctx):
    while not ctx.join():
        pass


def _jax_moments(opt_state):
    import jax
    import optax

    from sod_tpu_torch.models.convert import state_dict_from_jax

    st = [s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    return (state_dict_from_jax(jax.device_get(st.mu)),
            state_dict_from_jax(jax.device_get(st.nu)))


def _jax_run(params, batches, mesh=None, level=None, arch="vit_small", **step_kw):
    """sod_tpu's step(s) on one device, or on ``mesh`` under ``level``
    (``tests/test_fsdp.py``'s ``_fsdp_step``)."""
    import jax
    import jax.numpy as jnp

    from sod_tpu.config import Config as JaxConfig
    from sod_tpu.models.maskformer import MaskFormerConfig as JMC
    from sod_tpu.models.vit import ViTConfig as JViT
    from sod_tpu.train.optim import build_optimizer as jbuild
    from sod_tpu.train.step import make_train_step as jstep
    from sod_tpu_torch.models.convert import state_dict_from_jax

    cfg = JaxConfig(batch_size=B, compute_dtype="float32", use_pallas_attention=False,
                    max_gt_masks=2, fsdp=level or "none", arch=arch)
    mcfg = JMC(n_queries=4, n_decoder_layers=2, arch=arch, vit=JViT(**_vit()))
    tx = jbuild(cfg, n_iters_per_epoch=10)
    jb = [{k: jnp.asarray(v) for k, v in b.items()} for b in batches]
    if mesh is None:
        step, p, opt = jstep(cfg, tx, mcfg, **step_kw), params, tx.init(params)
        for b in jb:
            p, opt, m = step(p, opt, b)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        from sod_tpu.parallel import (fsdp_param_shardings, opt_state_shardings,
                                      shard_batch as jshard, shard_opt_state, shard_params)

        p = shard_params(params, mesh)
        override = fsdp_param_shardings(p, mesh)
        opt_sh = opt_state_shardings(tx, p, param_shardings=override)
        opt = shard_opt_state(tx, p, shardings=opt_sh)
        step = jstep(cfg, tx, mcfg, out_shardings=(
            jax.tree.map(lambda leaf: leaf.sharding, p), opt_sh, NamedSharding(mesh, P())),
            **step_kw)
        with jax.set_mesh(mesh):
            for b in jb:
                p, opt, m = step(p, opt, jshard(b, mesh))
    mu, nu = _jax_moments(opt)
    return {"metrics": {k: float(v) for k, v in m.items()},
            "params": state_dict_from_jax(jax.device_get(p)), "mu": mu, "nu": nu}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from sod_tpu.models.maskformer import MaskFormerConfig as JMC
    from sod_tpu.models.vit import ViTConfig as JViT
    from sod_tpu.parallel import make_mesh as jax_mesh
    from sod_tpu.train.evaluator import Evaluator as JaxEvaluator
    from sod_tpu_torch.cli import generate_masks as maskgen_cli
    from sod_tpu_torch.data.mask_generator import MaskGenerator
    from sod_tpu_torch.models.convert import state_dict_from_jax
    from sod_tpu_torch.train.trainer import Trainer
    from PIL import Image

    from tests._fixtures import make_duts

    tmp = tmp_path_factory.mktemp("dp")
    rng = np.random.RandomState(0)
    from test_torch_model_options import _jax_tree

    # sod_tpu trees drawn with numpy (its jax init takes seconds a tree)
    params = _jax_tree(JMC(n_queries=4, n_decoder_layers=2, vit=JViT(**_vit())), 0)
    eval_params = _jax_tree(JMC(n_queries=4, n_decoder_layers=2,
                                vit=JViT(**_vit(pos_grid=8, depth=2))), 1)
    sd = {k: np.array(v) for k, v in state_dict_from_jax(params).items()}
    batches = _batches()
    rn_params = _jax_tree(JMC(n_queries=4, n_decoder_layers=2, arch="resnet50",
                              vit=JViT(**_vit())), 3)
    rn_sd = {k: np.array(v) for k, v in state_dict_from_jax(rn_params).items()}
    rn_batches = [{k: v[:4] for k, v in b.items()} for b in _batches(1, b=4, seed=1)]
    # sod_tpu's steps, compiled in threads side by side while the rest is set up
    runs_kw = {"single": ((batches,), {}),
               "mesh2 zero1": ((batches, jax_mesh(2), "zero1"), {}),
               "averaged": ((batches[:1],), {"accum_steps": 2}),
               "exact": ((batches[:1],), {"accum_steps": 2, "mode": "exact"}),
               "mesh4 zero1": ((batches[:1], jax_mesh(4), "zero1"), {}),
               "resnet50 mesh2": ((rn_batches, jax_mesh(2)), {"arch": "resnet50"}),
               "resnet50 single": ((rn_batches,), {"arch": "resnet50"})}
    pool = ThreadPoolExecutor(len(runs_kw))
    futures = {k: pool.submit(_jax_run, rn_params if k.startswith("resnet") else params,
                              *a, **kw) for k, (a, kw) in runs_kw.items()}
    make_duts(tmp / "ev", rng, n_test=6, test_hw=(40, 48), variable_test=True)
    make_duts(tmp / "tr", rng, n_test=0, n_train=8, train_hw=(64, 64))

    # the single-device epoch and its checkpoint, before the ranks resume it
    t_sd = {k: torch.from_numpy(v) for k, v in sd.items()}
    single = Trainer(_trainer_cfg(tmp / "tr", suffix="single"), device="cpu",
                     state_dict=t_sd, mcfg=_mcfg())
    single._train_epoch(1)
    inputs = {"sd": sd, "batches": batches, "resnet_sd": rn_sd, "resnet_batches": rn_batches,
              "eval_sd": state_dict_from_jax(eval_params),
              "eval_dir": str(tmp / "ev"), "train_dir": tmp / "tr",
              "single_ckpt": single.latest_path}
    for n in (2, 4):
        os.makedirs(tmp / f"g{n}")
        torch.save(dict(inputs, n=n), tmp / f"g{n}" / "inputs.pt")
    # the ranks (and the CLI's) each take two threads of the host
    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "2"
    groups = {n: _start(n, tmp / f"g{n}") for n in (2, 4)}

    os.makedirs(tmp / "img")
    paths = []
    for i in range(5):
        img = np.full((64, 80, 3), 30, np.uint8)
        img[16:48, 20 + i:60] = 220
        img += rng.randint(0, 10, img.shape).astype(np.uint8)
        paths.append(str(tmp / "img" / f"img_{i}.jpg"))
        Image.fromarray(img).save(paths[-1])
    argv = ["--p_images", str(tmp / "img" / "*.jpg"), "--device", "cpu",
            "--feature_types", "dino", "--image_size", "64", "--batch_size", "4"]
    cli_run = threading.Thread(target=maskgen_cli.main,
                               args=(argv + ["--fp", str(tmp / "two.json"), "--n_devices", "2"],))
    cli_run.start()
    if threads is None:
        os.environ.pop("OMP_NUM_THREADS")
    else:
        os.environ["OMP_NUM_THREADS"] = threads

    from sod_tpu.config import Config as JaxConfig

    ref = {}
    with jax.set_mesh(jax_mesh(2)):
        ref["evaluator"] = JaxEvaluator(
            eval_params, JaxConfig(dir_dataset=str(tmp / "ev"), compute_dtype="float32",
                                   use_pallas_attention=False, num_workers=2),
            JMC(n_queries=4, n_decoder_layers=2, vit=JViT(**_vit(pos_grid=8, depth=2))),
            batch_size=4, mesh=jax_mesh(2))("duts")
    ref["maskgen"] = MaskGenerator(feature_types=["dino"], image_size=64, batch_size=4,
                                   device="cpu")(paths)
    # the single-device Trainer resumed from its own checkpoint for epoch 2
    single2 = Trainer(_trainer_cfg(tmp / "tr", suffix="single2"), device="cpu",
                      state_dict=t_sd, mcfg=_mcfg())
    single2._train_epoch(single2.resume(single.latest_path))
    ref["trainer single"] = {k: v.clone() for k, v in single.model.state_dict().items()}
    ref["trainer single resumed"] = single2.model.state_dict()
    ref.update({k: f.result() for k, f in futures.items()})
    pool.shutdown()

    for ctx in groups.values():
        _join(ctx)
    cli_run.join()
    out = {n: torch.load(tmp / f"g{n}" / f"ranks{n}.pt", weights_only=False) for n in (2, 4)}
    with open(tmp / "two.json") as f:
        out["maskgen json"] = f.read()
    return {"ranks": out[2], "ranks4": out[4], "ref": ref, "tmp": tmp,
            "maskgen json": out["maskgen json"]}


def _close(got, want, keys=("params", "mu", "nu")):
    for key in keys:
        for name, w in want[key].items():
            np.testing.assert_allclose(np.asarray(got[key][name]), np.asarray(w),
                                       err_msg=f"{key} {name}", **TOL)


# ------------------------------------------------------------ the train step

@pytest.mark.parametrize("level", LEVELS)
def test_two_rank_steps_equal_sod_tpus_single_device_steps(runs, level):
    """Two steps on 2 ranks under each fsdp level against sod_tpu's two
    single-device steps: loss, parameters, both moments."""
    got, want = runs["ranks"][level], runs["ref"]["single"]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    for k in ("grad_norm", "iou", "contrastive_loss", "dice_loss"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    _close(got, want)


def test_zero1_steps_equal_sod_tpus_mesh2_zero1_steps(runs):
    got, want = runs["ranks"]["zero1"], runs["ref"]["mesh2 zero1"]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    _close(got, want)


def test_the_clip_binds_and_positives_span_the_ranks(runs):
    """The gradient norm is far above the clip's 1.0, and the contrastive
    term (every positive pair split across the ranks) is sod_tpu's."""
    got, want = runs["ranks"]["none"]["metrics"], runs["ref"]["single"]["metrics"]
    assert got["grad_norm"] > 10.0
    assert got["contrastive_loss"] > 0.5
    np.testing.assert_allclose(got["contrastive_loss"], want["contrastive_loss"], rtol=1e-5)


@pytest.mark.parametrize("mode", ["averaged", "exact"])
def test_zero1_accumulation_equals_sod_tpus(runs, mode):
    """Two micro-batches: each rank holds its block of each; ``averaged``
    equals sod_tpu's averaged step, ``exact`` its GradCache step."""
    got, want = runs["ranks"][f"zero1 {mode}"], runs["ref"][mode]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    _close(got, want)


def test_four_ranks_zero1_equal_sod_tpus_mesh4(runs):
    got, want = runs["ranks4"]["zero1"], runs["ref"]["mesh4 zero1"]
    np.testing.assert_allclose(got["metrics"]["loss"], want["metrics"]["loss"], rtol=1e-5)
    _close(got, want)
    assert got["bytes"]["moments"] < runs["ranks"]["zero1"]["bytes"]["moments"]


def _outside_tol(got, want, names):
    """Elements of the parameters and both moments (``names``: the port's
    parameters) of ``got`` outside ``TOL`` of ``want``."""
    return sum(int((np.abs(np.asarray(got[key][n]) - np.asarray(want[key][n]))
                    > TOL["atol"] + TOL["rtol"] * np.abs(np.asarray(want[key][n]))).sum())
               for key in ("params", "mu", "nu") for n in names)


def test_resnet50_step_with_global_batch_norm(runs):
    """``arch: resnet50`` on 2 ranks (2 images each, a positive pair across
    them) against sod_tpu's step on ``make_mesh(2)`` and on one device, from
    one sod_tpu tree: train-mode BN over the global batch.

    The 106 running BN statistics are held to sod_tpu's mesh step at
    sod_tpu's tolerances.  The rest cannot all be: sod_tpu's two layouts
    disagree with each other by 1.0e-5 in the loss and on 1.2e-4 of the
    parameter and moment elements (Adam's first step moves a weight whose
    clipped gradient is near its eps by +-lr, so the order of a sum flips
    it, and the random ResNet-50's stem gradient moves by ~2% of its largest
    moment; PERF.md, open questions).  So against each of sod_tpu's layouts
    the port must agree as closely as sod_tpu's other layout does, within a
    factor of two: the loss (or within rtol 1e-5), and the count of
    elements outside the tolerances."""
    got = runs["ranks"]["resnet50"]
    mesh2, single = runs["ref"]["resnet50 mesh2"], runs["ref"]["resnet50 single"]
    bn = [k for k in mesh2["params"] if k.endswith(("running_mean", "running_var"))]
    assert len(bn) == 106
    _close({"params": got["params"]}, {"params": {k: mesh2["params"][k] for k in bn}},
           keys=("params",))
    names = list(got["mu"])
    for want, other in ((mesh2, single), (single, mesh2)):
        loss = want["metrics"]["loss"]
        assert abs(got["metrics"]["loss"] - loss) <= max(
            1e-5 * abs(loss), 2 * abs(other["metrics"]["loss"] - loss))
        outside, spread = _outside_tol(got, want, names), _outside_tol(other, want, names)
        assert outside <= 2 * spread, (outside, spread)


def test_each_rank_holds_its_share_of_the_state(runs):
    """Bytes per rank after the steps: ZeRO-1 halves every sharded leaf's
    moments, FSDP-full its weights too; the leaves that shard are the MLP's;
    no rank keeps a gradient between steps."""
    r = runs["ranks"]
    sharded = r["zero1"]["sharded"]
    assert sharded and all(".mlp.fc" in n for n in sharded)
    assert r["full"]["sharded"] == sharded and r["none"]["sharded"] == []
    sizes = {n: r["none"]["params"][n].size * 4 for n in r["none"]["mu"]}
    half = sum(sizes[n] for n in sharded) // 2
    none_b = r["none"]["bytes"]
    assert none_b == {"weights": sum(sizes.values()), "moments": 2 * sum(sizes.values()),
                      "grads": 0}
    assert r["zero1"]["bytes"] == {"weights": none_b["weights"],
                                   "moments": none_b["moments"] - 2 * half, "grads": 0}
    assert r["full"]["bytes"] == {"weights": none_b["weights"] - half,
                                  "moments": none_b["moments"] - 2 * half, "grads": 0}


def test_replicated_broadcasts_rank0s_weights(runs):
    got = runs["ranks"]["replicated"]
    model = MaskFormer(_mcfg())
    model.load_state_dict(random_state_dict(model, 100))
    for k, v in model.state_dict().items():
        assert torch.equal(got[k], v), k


def test_gather_rows_backward_is_the_ranks_own_rows(runs):
    assert torch.equal(runs["ranks"]["gather grad"], torch.tensor([[0.] * 3, [1.] * 3]))


# ------------------------------------------------------------ the Evaluator

def test_evaluator_on_two_ranks_equals_sod_tpus_mesh2(runs):
    """6 images at batch 4: the ragged final batch leaves rank 1 only
    padding rows; every rank returns sod_tpu's metrics; rank 0 wrote the
    CSV, one row per image."""
    got, want = runs["ranks"]["evaluator"], runs["ref"]["evaluator"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4, atol=1e-5, err_msg=k)
    with open(runs["tmp"] / "g2" / "ev_csv" / "metrics_duts.txt") as f:
        assert len(f.read().splitlines()) == 1 + 6
    assert "not divisible by the mesh's data axis (2)" in runs["ranks"]["evaluator indivisible"]


# ------------------------------------------------------------ MaskGenerator

def test_mask_generator_cli_on_two_ranks_writes_the_one_rank_json(runs):
    """``cli.generate_masks --n_devices 2 --device cpu``: 5 images at batch 4
    (the last batch wrap-padded), labels gathered, rank 0's JSON byte-equal
    to one rank's."""
    assert runs["maskgen json"] == json.dumps(runs["ref"]["maskgen"])


# ------------------------------------------------------------ the loader

def test_rank_loaders_decode_their_rows(runs):
    """``rows``: this rank's positions of each shuffled global batch, through
    threads and through workers forked after the group is up (which touch
    no CUDA); ``shard_by_process``: sod_tpu's stride with wrap-padding."""
    r = runs["ranks"]
    order = np.arange(11)
    np.random.default_rng([3, 1]).shuffle(order)
    batches = [order[i:i + 4] for i in range(0, 11, 4)]
    assert r["rows procs=False"] == [list(b[:2]) for b in batches]
    assert r["rows procs=True"] == r["rows procs=False"]
    assert not r["cuda in workers=True"]
    padded = np.concatenate([order, order[:1]])[0::2]
    assert r["shard_by_process"] == ([list(padded[i:i + 2]) for i in range(0, 6, 2)], 3)


# ------------------------------------------------------------ the Trainer

def test_trainer_full_epoch_equals_single_device_and_resumes_without_mesh(runs):
    """One epoch on 2 ranks under fsdp full equals the single-device epoch;
    its ``.pt`` (rank 0's, the whole state) resumes in a Trainer with no mesh."""
    from sod_tpu_torch.train.trainer import Trainer

    got = runs["ranks"]["trainer full"]
    for k, v in runs["ref"]["trainer single"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=k, **TOL)
    t = Trainer(_trainer_cfg(runs["tmp"] / "tr", suffix="again"), device="cpu",
                mcfg=_mcfg())
    assert t.resume(got["path"]) == 2
    for k, v in got["params"].items():
        assert torch.equal(t.model.state_dict()[k], v), k
    assert got["bytes"]["weights"] < sum(v.numel() * 4 for v in got["params"].values())
    # the visualizer ran on rank 0's first image, on the gathered weights
    assert got["visualized"] == [(0, {"mask_pred": (1, 4, 16, 16), "objectness": (1, 4)}),
                                 (1, {"mask_pred": (1, 4, 16, 16), "objectness": (1, 4)})]


def test_trainer_zero1_resumes_a_single_device_checkpoint(runs):
    got = runs["ranks"]["trainer zero1 resumed"]
    assert got["next"] == 2
    for k, v in runs["ref"]["trainer single resumed"].items():
        np.testing.assert_allclose(got["params"][k].numpy(), v.numpy(), err_msg=k, **TOL)


# ------------------------------------------------------------ errors

def test_mesh_errors_have_sod_tpus_types(runs):
    r = runs["ranks"]
    assert "not divisible by the mesh's data axis (2)" in r["indivisible batch"]
    assert "requires the XLA compute path" in r["full with a kernel flag"]
    with pytest.raises(ValueError, match="requested 999 devices"):
        make_mesh(999, "cpu")
    with pytest.raises(ValueError, match="data mesh axis"):
        assert_fsdp_compatible(Config(fsdp="zero1"), None)
    assert data_size(None) == 1
