"""Multi-card dryrun and the flagship forward of the port (twin of
``__graft_entry__.py``).

``entry(device)``          ``(fn, example_args)`` of the flagship forward:
                           SelfMask nq20 (ViT-S/8 encoder, 6-layer 20-query
                           decoder) on seeded random weights and a zero bf16
                           image; the encoder's attention runs through K2's
                           forward, 12 launches (``use_pallas_attention``).
``dryrun_multichip(n)``    every multi-card layout of ``parallel/`` on ``n``
                           ranks, each phase held to the one-device run.

Ranks are processes (``parallel/mesh.py`` ``spawn_ranks``): NCCL with rank r
on ``cuda:r``, or gloo on the CPU.  Every rank runs the one-device reference
itself (the same step code, no mesh), then each phase under its mesh:

1. two data-mesh steps and the IoU@0.5 of the best query, its mean over
   the whole mesh (``gather_rows``);
2. accumulation over two micro-batches, averaged, and 2b ``mode="exact"``
   (GradCache), whose one-device step equals the non-accumulated step;
3. one step, the whole state written by rank 0 to a ``.pt``, restored by
   every rank, a second step: the uninterrupted run;
4. the Evaluator's canvas path over the mesh on an on-disk DUTS-TE that
   rank 0 writes, against the one-device Evaluator;
5. TP at (n/2) x 2; 6. PP at (n/2) x 2; 7. SP at (n/2) x 2 (n >= 4, even);
8. FSDP-full over ``data`` with ``min_size=1024``; 8b. ZeRO-1 x TP (n >= 4,
   even), moments sharded over ``data`` and ``model``;
9. p3 at (n/4) x 2 x 2 with ZeRO-1; 10. sptp at (n/4) x 2 x 2 (n % 8 == 0).

Tolerances are the reference's: loss rtol 1e-4, parameters atol 1e-4 rtol
1e-3, the Evaluator's metrics rtol 1e-4 atol 1e-5.  A failed check raises in
its rank, and ``spawn_ranks`` then raises.  Phase 8 needs a data axis above
1 to shard anything, as the reference's does.

``python -m sod_tpu_torch.dryrun [--n_devices N] [--device cuda|cpu]`` runs
``dryrun_multichip`` (N defaults to every card; 8 ranks on the CPU, the
reference's own size), then ``entry()``'s forward, and prints its shapes.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from sod_tpu_torch.config import Config
from sod_tpu_torch.models.maskformer import (MaskFormer, MaskFormerConfig, config_from,
                                             random_state_dict)
from sod_tpu_torch.models.vit import ViTConfig

PHASES = ("1", "2", "2b", "3", "4", "5", "6", "7", "8", "8b", "9", "10")
LOSS_RTOL = 1e-4
PARAMS = dict(atol=1e-4, rtol=1e-3)
EVAL = dict(rtol=1e-4, atol=1e-5)
IMAGE = 32                                   # the dryrun's image side


def entry(device="cuda"):
    """(fn, example_args) of the flagship forward: ``fn(model, x)`` returns
    ``(mask_pred, objectness)`` of ``MaskFormer(config_from(Config()))`` on
    seeded random f32 weights, ``x`` a zero bf16 [1, 224, 224, 3] image."""
    mcfg = config_from(Config())              # nq20, 6 decoder layers, ViT-S/8, 224 px
    model = MaskFormer(mcfg)
    model.load_state_dict(random_state_dict(model, 0))
    model.to(device).eval()
    x = torch.zeros((1, 224, 224, 3), dtype=torch.bfloat16, device=device)

    def fn(model, x):
        with torch.no_grad():
            out = model(x)
        return out["mask_pred"], out["objectness"]

    return fn, (model, x)


def make_batch(b: int, seed: int) -> Dict[str, np.ndarray]:
    """The reference's batch of ``b`` drawn by ``RandomState(seed)``, in its
    order."""
    rng = np.random.RandomState(seed)
    return {"image": rng.rand(b, IMAGE, IMAGE, 3).astype(np.float32),
            "gt_masks": (rng.rand(b, 2, IMAGE, IMAGE) > 0.5).astype(np.float32),
            "gt_valid": np.ones((b, 2), bool),
            "labels": rng.randint(0, 10, size=(b,))}


def write_eval_set(root: str, n_images: int) -> None:
    """The reference's DUTS-TE under ``root``: ``n_images`` random JPEGs of
    40-48 x 40-48 px, each with the same GT rectangle as a PNG."""
    from PIL import Image

    rng = np.random.RandomState(0)
    duts = os.path.join(root, "DUTS")
    for sub in ("DUTS-TE-Image", "DUTS-TE-Mask"):
        os.makedirs(os.path.join(duts, sub), exist_ok=True)
    for i in range(n_images):
        h, w = 40 + 8 * (i % 2), 48 - 8 * (i % 3 == 0)
        img = (rng.rand(h, w, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(os.path.join(duts, "DUTS-TE-Image", f"t{i}.jpg"))
        gt = np.zeros((h, w), np.uint8)
        gt[8:30, 10:40] = 255
        Image.fromarray(gt).save(os.path.join(duts, "DUTS-TE-Mask", f"t{i}.png"))


def resize_nearest_half_pixel(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """``jax.image.resize(..., "nearest")`` over the trailing two axes: the
    source index of output i is floor((i + 0.5) * in / out), in f32 (torch's
    ``nearest`` takes floor(i * in / out))."""
    def index(n_in: int, n_out: int) -> torch.Tensor:
        pos = (torch.arange(n_out, dtype=torch.float32) + 0.5) * n_in / n_out
        return pos.floor().long().to(x.device)

    return x[..., index(x.shape[-2], out_h)[:, None], index(x.shape[-1], out_w)[None, :]]


class _Rank:
    """One rank's dryrun: its data mesh, the tiny model's weights, the two
    batches on its device and the one-device reference."""

    def __init__(self, n: int, device, state_dict, workdir: str, say: Callable):
        from sod_tpu_torch.parallel import make_mesh
        from sod_tpu_torch.parallel.mesh import rank_device

        self.n, self.workdir, self.say = n, workdir, say
        self.mesh = make_mesh(n, device)
        self.device = torch.device(rank_device(str(device), dist.get_rank()))
        self.kind = torch.device(device).type
        self.cfg = Config(batch_size=2 * n, compute_dtype="float32",
                          use_pallas_attention=False, max_gt_masks=2)
        self.mcfg = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(
            patch_size=8, embed_dim=32, depth=2, n_heads=2, pos_grid=4))
        if state_dict is None:
            state_dict = random_state_dict(MaskFormer(self.mcfg), 0)
        self.sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state_dict.items()}
        self.batches = [{k: torch.from_numpy(v).to(self.device) for k, v in
                         make_batch(self.cfg.batch_size, s).items()} for s in (0, 1)]

    def model(self) -> MaskFormer:
        model = MaskFormer(self.mcfg)
        model.load_state_dict(self.sd)
        return model.to(self.device)

    def train(self, batches, mesh=None, layout_fn: Optional[Callable] = None,
              apply_fn: Optional[Callable] = None, accum: int = 1, mode: str = "averaged",
              model: Optional[MaskFormer] = None, layout=None, opt=None) -> Dict:
        """Train steps on ``batches`` (this rank's rows of each under
        ``mesh``; the one-device step without): the last loss, the whole
        state after them, and the model, layout and optimizer."""
        from sod_tpu_torch.parallel import replicated, shard_batch
        from sod_tpu_torch.parallel.fsdp import StateLayout
        from sod_tpu_torch.train.optim import build_optimizer
        from sod_tpu_torch.train.step import make_train_step

        if model is None:
            model = self.model()
            if mesh is not None:
                replicated(model, mesh)
                layout = (layout_fn or (lambda m: StateLayout(m, mesh)))(model)
            opt = build_optimizer(self.cfg, model.parameters() if layout is None
                                  else layout.tensors, n_iters_per_epoch=10)
        step = make_train_step(self.cfg, model, opt, accum, mode, layout=layout,
                               apply_fn=apply_fn)
        for b in batches:
            metrics = step(b if mesh is None else shard_batch(b, mesh, accum))
        state = model.state_dict() if layout is None else layout.full_state(opt)[0]
        return {"loss": float(metrics["loss"]), "model": model, "layout": layout, "opt": opt,
                "state": {k: v.detach().cpu().clone() for k, v in state.items()}}

    def iou(self, model: MaskFormer, batch, mesh=None) -> float:
        """Mean IoU@0.5 of the best query against the first GT mask, over
        the global batch (every rank's rows under ``mesh``)."""
        from sod_tpu_torch.parallel import shard_batch
        from sod_tpu_torch.parallel.mesh import gather_rows

        if mesh is not None:
            batch = shard_batch(batch, mesh)
        with torch.no_grad():
            pred = model(batch["image"])["mask_pred"][:, -1] > 0.5      # [B, Q, h, w]
            gt = resize_nearest_half_pixel(batch["gt_masks"][:, 0], *pred.shape[-2:]) > 0.5
            inter = (pred & gt[:, None]).sum((-1, -2)).float()
            union = (pred | gt[:, None]).sum((-1, -2)).float()
            best = (inter / (union + 1e-7)).amax(1)
            if mesh is not None:
                best = gather_rows(best, mesh)
        return float(best.mean())

    def matches(self, run: Dict, want_loss: float, want_state, what: str) -> None:
        assert np.isfinite(run["loss"]), f"{what}: non-finite loss {run['loss']}"
        np.testing.assert_allclose(run["loss"], want_loss, rtol=LOSS_RTOL, err_msg=what)
        for k, w in want_state.items():
            np.testing.assert_allclose(run["state"][k].numpy(), w.numpy(),
                                       err_msg=f"{what}: {k}", **PARAMS)

    def barrier(self) -> None:
        dist.barrier(group=self.mesh.get_group("data"))


def _reference(r: _Rank) -> Dict:
    ref = r.train(r.batches)
    return {"loss": ref["loss"], "state": ref["state"],
            "iou": r.iou(ref["model"], r.batches[0])}


def phase_1(r: _Rank, ref: Dict) -> Dict:
    run = r.train(r.batches, r.mesh)
    iou = r.iou(run["model"], r.batches[0], r.mesh)
    r.matches(run, ref["loss"], ref["state"], "phase 1")
    np.testing.assert_allclose(iou, ref["iou"], rtol=LOSS_RTOL, err_msg="phase 1 iou")
    r.say(f"loss={run['loss']:.4f} eval_iou={iou:.4f} matches single-device ok")
    return {"loss": run["loss"], "iou": iou}


def phase_2(r: _Rank, ref: Dict) -> Dict:
    want = r.train(r.batches[:1], accum=2)
    run = r.train(r.batches[:1], r.mesh, accum=2)
    r.matches(run, want["loss"], want["state"], "phase 2")
    r.say(f"grad-accum(2) loss={run['loss']:.4f} matches single-device ok")
    return {"loss": run["loss"]}


def phase_2b(r: _Rank, ref: Dict) -> Dict:
    one = r.train(r.batches[:1])
    want = r.train(r.batches[:1], accum=2, mode="exact")
    r.matches(want, one["loss"], one["state"], "phase 2b: exact vs one step")
    run = r.train(r.batches[:1], r.mesh, accum=2, mode="exact")
    r.matches(run, want["loss"], want["state"], "phase 2b")
    r.say(f"exact grad-accum(2) loss={run['loss']:.4f} == non-accum step, sharded ok")
    return {"loss": run["loss"]}


def phase_3(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel import replicated
    from sod_tpu_torch.parallel.fsdp import StateLayout
    from sod_tpu_torch.parallel.mesh import is_main
    from sod_tpu_torch.train.checkpoints import restore_checkpoint, save_checkpoint
    from sod_tpu_torch.train.optim import build_optimizer

    first = r.train(r.batches[:1], r.mesh)
    model_state, opt_state = first["layout"].full_state(first["opt"])
    path = os.path.join(r.workdir, "step1.pt")
    if is_main(r.mesh):
        save_checkpoint(path, model_state, opt_state, epoch=0, n_iters=1)
    r.barrier()
    ckpt = restore_checkpoint(path, map_location=r.device)
    model = replicated(r.model(), r.mesh)
    layout = StateLayout(model, r.mesh)
    opt = build_optimizer(r.cfg, layout.tensors, n_iters_per_epoch=10)
    layout.load_full_state(ckpt["model"], opt, ckpt["optimizer"])
    run = r.train(r.batches[1:], r.mesh, model=model, layout=layout, opt=opt)
    r.matches(run, ref["loss"], ref["state"], "phase 3")
    r.say(f"resume-then-continue loss={run['loss']:.4f} matches uninterrupted run ok")
    return {"loss": run["loss"]}


def phase_4(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel.mesh import is_main
    from sod_tpu_torch.train.evaluator import Evaluator

    root = os.path.join(r.workdir, "eval")
    b_eval = 2 * r.n
    if is_main(r.mesh):
        write_eval_set(root, b_eval)
    r.barrier()
    ecfg = Config(dir_dataset=root, compute_dtype="float32", use_pallas_attention=False,
                  num_workers=2, max_gt_masks=2)
    model = r.model()
    single = Evaluator(model, ecfg, r.mcfg, batch_size=b_eval, device=r.device)("duts")
    multi = Evaluator(model, ecfg, r.mcfg, batch_size=b_eval, device=r.device,
                      mesh=r.mesh)("duts")
    for k in single:
        np.testing.assert_allclose(multi[k], single[k], err_msg=f"phase 4: {k}", **EVAL)
    r.say(f"sharded Evaluator canvas path iou={multi['iou']:.4f} matches single-device ok")
    return {"single": single, "multi": multi}


def phase_5(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel import make_mesh_2d, shard_params
    from sod_tpu_torch.parallel.tp import make_tp_apply

    mesh = make_mesh_2d(r.n // 2, 2, r.kind)
    run = r.train(r.batches, mesh, lambda m: shard_params(m, mesh), make_tp_apply(mesh))
    d = r.mcfg.embed_dim
    rows = {tuple(b.attn.qkv.weight.shape) for b in run["model"].encoder.blocks}
    assert rows == {(3 * d // 2, d)}, f"qkv not actually sharded: {rows}"
    r.matches(run, ref["loss"], ref["state"], "phase 5")
    r.say(f"tensor-parallel ({r.n // 2}x2 mesh) loss={run['loss']:.4f} matches "
          "single-device ok")
    return {"loss": run["loss"]}


def phase_6(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel import make_mesh_pp, make_pp_apply, shard_params_pp

    mesh = make_mesh_pp(r.n // 2, 2, r.kind)
    depth = r.mcfg.vit.depth
    run = r.train(r.batches, mesh, lambda m: shard_params_pp(m, mesh, depth),
                  make_pp_apply(mesh))
    held = sum(b.attn.qkv.weight.numel() > 0 for b in run["model"].encoder.blocks)
    assert held == depth // 2, f"blocks not actually layer-sharded: {held} held"
    r.matches(run, ref["loss"], ref["state"], "phase 6")
    r.say(f"pipeline-parallel ({r.n // 2}x2 data x pipe mesh, GPipe) "
          f"loss={run['loss']:.4f} matches single-device ok")
    return {"loss": run["loss"]}


def phase_7(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel import make_mesh_sp, make_sp_apply
    from sod_tpu_torch.parallel.fsdp import StateLayout
    from sod_tpu_torch.parallel.sp import SEQ_PARTIAL

    mesh = make_mesh_sp(r.n // 2, 2, r.kind)
    run = r.train(r.batches, mesh, lambda m: StateLayout(m, mesh, partial=SEQ_PARTIAL),
                  make_sp_apply(mesh))
    r.matches(run, ref["loss"], ref["state"], "phase 7")
    r.say(f"sequence-parallel ({r.n // 2}x2 data x seq mesh, ring attention) "
          f"loss={run['loss']:.4f} matches single-device ok")
    return {"loss": run["loss"]}


def phase_8(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel import fsdp_param_shardings
    from sod_tpu_torch.parallel.fsdp import StateLayout

    # the dryrun's tiny leaves sit below MIN_SHARD_SIZE: drop it, so that
    # the sharding really runs
    run = r.train(r.batches, r.mesh, lambda m: StateLayout(
        m, r.mesh, "full", specs=fsdp_param_shardings(m, r.mesh, min_size=1024)))
    r.matches(run, ref["loss"], ref["state"], "phase 8")
    n_sh = len(run["layout"].sharded)
    assert n_sh > 0, "FSDP phase ran fully replicated"
    r.say(f"FSDP/ZeRO ({n_sh} weight leaves + their moments stored sharded over data) "
          f"loss={run['loss']:.4f} matches single-device ok")
    return {"loss": run["loss"], "sharded": n_sh}


def phase_8b(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel import (make_mesh_2d, param_shardings, shard_params,
                                        zero1_moment_shardings)
    from sod_tpu_torch.parallel.tp import make_tp_apply

    mesh = make_mesh_2d(r.n // 2, 2, r.kind)

    def layout_fn(m):
        specs = zero1_moment_shardings(m, mesh, min_size=1024, mp=param_shardings(m, mesh))
        return shard_params(m, mesh, "zero1", specs=specs)

    run = r.train(r.batches, mesh, layout_fn, make_tp_apply(mesh))
    r.matches(run, ref["loss"], ref["state"], "phase 8b")
    lay = run["layout"]
    n_both = sum("model" in lay.mp.get(lay.names[i], {}) for i in lay.sharded)
    assert n_both > 0, "zero1 x TP ran without dual-axis moments"
    r.say(f"ZeRO-1 x TP ({r.n // 2}x2 mesh, {n_both} moment leaves sharded over data AND "
          f"model) loss={run['loss']:.4f} matches single-device ok")
    return {"loss": run["loss"], "dual": n_both}


def _blocks_q_shape(model: MaskFormer):
    """Each held block's q weight shape (its rows of the packed qkv's
    first third)."""
    return [(b.attn.qkv.weight.shape[0] // 3, b.attn.qkv.weight.shape[1])
            for b in model.encoder.blocks if b.attn.qkv.weight.numel()]


def phase_9(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel import (make_mesh_3d, make_p3_apply, p3_host_params,
                                        p3_param_shardings, shard_params_p3,
                                        zero1_moment_shardings)

    mesh = make_mesh_3d(r.n // 4, 2, 2, r.kind)
    depth, d = r.mcfg.vit.depth, r.mcfg.embed_dim

    def layout_fn(m):
        specs = zero1_moment_shardings(m, mesh, min_size=1024,
                                       mp=p3_param_shardings(m, mesh, depth))
        return shard_params_p3(m, mesh, depth, "zero1", specs=specs)

    run = r.train(r.batches, mesh, layout_fn, make_p3_apply(mesh))
    run["state"] = p3_host_params(run["layout"])      # the packed host copy
    r.matches(run, ref["loss"], ref["state"], "phase 9")
    q = _blocks_q_shape(run["model"])
    assert q == [(d // 2, d)] * (depth // 2), f"blocks not dual-axis sharded: {q}"
    r.say(f"3-D mesh ({r.n // 4}x2x2 data x pipe x model, GPipe stages of Megatron TP "
          f"groups + ZeRO-1 moments) loss={run['loss']:.4f} matches single-device ok")
    return {"loss": run["loss"]}


def phase_10(r: _Rank, ref: Dict) -> Dict:
    from sod_tpu_torch.parallel import (make_mesh_sptp, make_sptp_apply, p3_host_params,
                                        shard_params_sptp)

    mesh = make_mesh_sptp(r.n // 4, 2, 2, r.kind)
    depth, d = r.mcfg.vit.depth, r.mcfg.embed_dim
    run = r.train(r.batches, mesh, lambda m: shard_params_sptp(m, mesh),
                  make_sptp_apply(mesh))
    run["state"] = p3_host_params(run["layout"])      # the packed host copy
    r.matches(run, ref["loss"], ref["state"], "phase 10")
    q = _blocks_q_shape(run["model"])
    assert q == [(d // 2, d)] * depth, f"blocks not model-sharded: {q}"
    r.say(f"seq x tensor mesh ({r.n // 4}x2x2 data x seq x model, ring attention inside "
          f"Megatron TP groups) loss={run['loss']:.4f} matches single-device ok")
    return {"loss": run["loss"]}


_PHASE_FNS = {"1": phase_1, "2": phase_2, "2b": phase_2b, "3": phase_3, "4": phase_4,
              "5": phase_5, "6": phase_6, "7": phase_7, "8": phase_8, "8b": phase_8b,
              "9": phase_9, "10": phase_10}


def gated(n: int, phases: Sequence[str] = PHASES) -> list:
    """The reference's gates: 5-7 and 8b at n >= 4 and even, 9-10 at
    n % 8 == 0."""
    two_d = n >= 4 and n % 2 == 0
    three_d = n >= 8 and n % 8 == 0
    return [p for p in phases if (p not in ("5", "6", "7", "8b") or two_d)
            and (p not in ("9", "10") or three_d)]


def run_phases(n: int, device="cuda", state_dict=None, phases: Sequence[str] = PHASES,
               workdir: Optional[str] = None) -> Dict:
    """This rank's dryrun over ``n`` ranks (``make_mesh(n)`` joins the
    spawned group; one rank starts its own): the one-device reference, then
    each of ``phases`` that the gates let through.  Rank 0 prints each
    phase's line.  Returns {"reference": ..., "lines": [...], phase: its
    numbers}.

    :param state_dict: the tiny model's weights (default: the port's seeded
        init).
    :param workdir: a directory every rank sees (the checkpoint, the
        evaluation images); default a temporary one (one rank only)."""
    with (contextlib.nullcontext(workdir) if workdir else tempfile.TemporaryDirectory()) as wd:
        lines = []

        def say(msg: str) -> None:
            line = f"sod_tpu_torch dryrun_multichip({n}): {msg}"
            lines.append(line)
            if dist.get_rank() == 0:
                print(line, flush=True)

        r = _Rank(n, device, state_dict, wd, say)
        ref = _reference(r)
        out = {"reference": ref}
        for p in gated(n, phases):
            out[p] = _PHASE_FNS[p](r, ref)
        out["lines"] = lines
        return out


def _rank_main(rank: int, n: int, device: str, state_dict, workdir: str,
               save_to: Optional[str]) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)              # n ranks share the host's cores
    out = run_phases(n, device, state_dict, workdir=workdir)
    if rank == 0 and save_to:
        torch.save({"lines": out["lines"], "reference": out["reference"],
                    "eval single": out["4"]["single"]}, save_to)


def dryrun_multichip(n_devices: int, device="cuda", state_dict=None,
                     save_to: Optional[str] = None) -> None:
    """Every multi-card phase on ``n_devices`` spawned ranks (NCCL on the
    cards, gloo on the CPU), each held to the one-device run; raises if a
    rank fails.  ``sod_tpu``'s ``ValueError`` when the device kind has
    fewer than ``n_devices``, before any rendezvous.

    :param state_dict: the tiny model's weights (default: the port's
        seeded init).
    :param save_to: rank 0 saves its phase lines, its one-device reference
        and its one-device Evaluator's metrics there (``torch.save``)."""
    from sod_tpu_torch.parallel.mesh import device_limit, spawn_ranks

    kind = torch.device(device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the dryrun runs over NCCL on the cards "
                           "(--device cpu runs it over gloo)")
    have = device_limit(kind)
    if n_devices > have:
        raise ValueError(f"requested {n_devices} devices, have {have}")
    sd = None if state_dict is None else {k: np.asarray(v) for k, v in state_dict.items()}
    with tempfile.TemporaryDirectory() as wd:
        spawn_ranks(_rank_main, n_devices, n_devices, device, sd, wd, save_to)


def main(argv=None) -> None:
    p = argparse.ArgumentParser("sod-tpu-torch dryrun")
    p.add_argument("--n_devices", type=int, default=None,
                   help="ranks (default: every card; 8 on the CPU)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (NCCL, one rank a card) or cpu (gloo)")
    args = p.parse_args(argv)
    n = args.n_devices or (torch.cuda.device_count()
                           if torch.device(args.device).type == "cuda" else 8)
    dryrun_multichip(n, args.device)
    fn, example = entry(args.device)
    out = fn(*example)
    print("entry ok:", tuple(tuple(t.shape) for t in out))


if __name__ == "__main__":
    main()
