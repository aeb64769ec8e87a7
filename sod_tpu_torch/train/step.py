"""The train step of the port (twin of ``sod_tpu/train/step.py``).

One step: the uint8 batch normalised on the device, the forward in the
compute dtype (bf16 in the live config, f32 master weights) in train mode,
the criterion on f32 casts, backward, global-norm clip and AdamW
(``train/optim.py``), then, for the ResNet-50 encoder, the BatchNorm
running statistics of the forward written into its buffers
(``merge_bn_stats``, after the update as in ``sod_tpu``).  The buffers are
not parameters: ``ClippedAdamW`` never sees them (``sod_tpu`` freezes them
with ``param_labels``: no gradient, no weight decay).  ``sod_tpu`` jits the
whole step; here it runs on the model's device, eagerly or from CUDA
graphs (below), and the metrics stay there as 0-d tensors until the
Trainer fetches them.

With ``use_binary_classifier=False`` the forward has no objectness, so the
criterion takes its ``objectness is None`` branch and the step trains on
the contrastive term alone, as ``sod_tpu``'s does.

Accumulation over ``accum_steps`` micro-batches, one update:

* ``"averaged"``: each micro loss normalised by its own valid-image count,
  the InfoNCE term over the micro-batch's negatives; gradients summed, then
  divided;
* ``"exact"`` (GradCache, ``sod_tpu/train/step.py:217-326``): the gradient
  of the whole batch's loss.  Pass 1 (only with a contrastive weight and
  labels) runs every micro-batch's forward without gradients, takes the
  pooled features ``Z`` of the whole batch and the gradient ``g_Z`` of the
  InfoNCE term on them; pass 2 runs each micro-batch's forward again and
  backward on ``main_sum_k / n_total + <features_k, g_Z_k>``, gradients
  summed.  Both passes run the same forward (K2, or K3 + K4), so ``g_Z`` is
  taken at the features that pass 2 differentiates.

In both modes the BN statistics are the mean of the (pass-2)
micro-batches', merged once after the update.

Under a data-parallel ``layout`` (``parallel/fsdp.py``'s ``StateLayout``
over a ``data`` mesh) the batch is this rank's rows of the global batch
(``parallel.mesh.batch_sharding``: under accumulation the rank's block of
every micro-batch) and the step computes ``sod_tpu``'s global-batch step:

* the criterion normalises by the global valid-image count and takes the
  contrastive term over the global batch (``criterion_forward(mesh=)``);
  exact mode gathers pass 1's features of every rank, in the global order;
* train-mode BatchNorm takes the global batch's statistics
  (``parallel.mesh.batch_over``);
* the gradients are reduced once per optimizer step: a flat all-reduce, and
  under ``zero1`` / ``full`` a reduce-scatter of the sharded leaves; the
  clip reads the norm of the whole reduced gradient, the optimizer steps on
  this rank's tensors and the layout publishes the weights;
* the metrics are all-reduced, so every rank returns the same values.

Under a model-sharding layout (``apply_fn``: TP, PP, SP, p3, sptp) the
forward is the layout's, ``layout`` holds this rank's shards and reduces as
the layout says (``parallel/fsdp.py``); the rest of the step is the same.

Spans (``utils/profiling.py``, recorded only while a profiler runs or under
``profiling.recording()``): ``step`` over the whole step, with counts
``rows`` and ``micro``; inside it ``forward`` (every forward, pass 1's
too), ``criterion``, ``backward`` (every ``.backward()`` and pass 1's
``autograd.grad``), one ``optimizer`` (the average of accumulated
gradients, the norm, the update and ``merge_bn_stats``) and, under a
layout, ``grad_sync`` (``gather``, ``reduce_grads``, ``publish`` and the
metrics' all-reduces).

On a CUDA model, with no layout, no ``apply_fn`` and one micro-batch, the
step is replayed from CUDA graphs: the first call with a batch's keys,
shapes, dtypes and device runs eagerly (the kernel libraries, the plans and
the allocator warm up), the second captures the step and every call with
that signature then replays it.  The capture ends one graph and begins the
next at every span's boundary, all in one memory pool, so a replay enters
and leaves the same spans around the same work; each call copies its batch
into the graphs' inputs, writes the optimizer's learning rate and bias
corrections (``ClippedAdamW.advance``), replays, and returns a copy of the
stacked metrics.  The kernels and their arithmetic are the eager step's.
Any other call runs eagerly.  ``graphed_steps`` and ``eager_steps`` count
the two, and the ``step`` span carries ``graphed`` (1 or 0); a replay
advances the ops' launch and linear counters by what its capture counted.

``make_eval_step``: the last layer's masks and objectness, for the
visualizer hooks.
"""
from __future__ import annotations

import contextlib
import gc
import sys
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sod_tpu_torch.data.augment import normalize_device
from sod_tpu_torch.losses.criterion import contrastive_loss, criterion_forward
from sod_tpu_torch.models.maskformer import MaskFormer
from sod_tpu_torch.models.resnet import merge_bn_stats
from sod_tpu_torch.parallel.mesh import (all_gather_into, batch_over, batch_sharding, data_group,
                                         data_size)
from sod_tpu_torch.train.optim import ClippedAdamW, global_norm
from sod_tpu_torch.utils import profiling
from sod_tpu_torch.utils.profiling import span

METRIC_KEYS = ("loss", "dice_loss", "ranking_loss", "classification_loss",
               "contrastive_loss", "iou", "grad_norm")


_DIAG = ("avg_dice_loss", "avg_ranking_loss", "avg_classification_loss", "avg_iou")

graphed_steps = 0              # steps replayed from CUDA graphs
eager_steps = 0                # steps run eagerly

# the ops' host counters that a step advances
_COUNTERS = {"sod_tpu_torch.ops.layers": ("tc_linears", "f32_linears"),
             "sod_tpu_torch.ops.gemm": ("launches", "nn_launches", "tn_launches",
                                        "ln_bwd_launches"),
             "sod_tpu_torch.ops.flash_attention": ("fwd_launches", "bwd_launches"),
             "sod_tpu_torch.ops.fused_attn": ("launches", "train_fwd_launches",
                                              "train_bwd_launches"),
             "sod_tpu_torch.ops.fused_mlp": ("launches", "save_launches", "bwd_launches")}


def _counts() -> Dict[Tuple[str, str], int]:
    return {(m, n): getattr(sys.modules[m], n) for m, names in _COUNTERS.items()
            if m in sys.modules for n in names}


def _set_counts(counts: Dict[Tuple[str, str], int]) -> None:
    for (m, n), v in counts.items():
        setattr(sys.modules[m], n, v)


def _graph_signature(model: MaskFormer, batch: Dict[str, torch.Tensor]) -> Optional[tuple]:
    """What a captured step holds fixed: each input's key, shape, dtype and
    device; None, the eager step, for a model off the card or a batch that
    holds anything but tensors."""
    if not (next(model.parameters()).is_cuda
            and all(isinstance(v, torch.Tensor) for v in batch.values())):
        return None
    return tuple((k, tuple(v.shape), v.dtype, v.device) for k, v in sorted(batch.items()))


class _Graphed:
    """``body(inputs)`` captured as CUDA graphs in one pool, a graph between
    each two span boundaries: ``items`` holds the graphs in order and, between
    them, ``(name, counts)`` where a span opens and None where one closes.
    ``inputs`` is the graphs' copy of the batch, ``output`` what ``body``
    returned, ``grads`` the gradients the captured backward writes,
    ``counted`` what ``body`` added to the ops' counters (which the capture
    leaves as they were)."""

    def __init__(self, signature: tuple, body: Callable, batch: Dict[str, torch.Tensor],
                 params: List[torch.Tensor]):
        self.signature = signature
        before = _counts()
        self.inputs = {k: v.clone() for k, v in batch.items()}
        self.items: list = []
        pool = torch.cuda.graph_pool_handle()
        graph = None

        def begin():
            nonlocal graph
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin(pool=pool)

        def end():
            with warnings.catch_warnings():      # two spans that meet leave one empty
                warnings.filterwarnings("ignore", "The CUDA Graph is empty")
                graph.capture_end()
            self.items.append(graph)

        def cut(name, counts):
            end()
            self.items.append(None if name is None else (name, counts))
            begin()

        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            begin()
            try:
                with profiling.cut_at_spans(cut):
                    self.output = body(self.inputs)
            except BaseException:
                with contextlib.suppress(RuntimeError):
                    graph.capture_end()
                raise
            end()
        torch.cuda.current_stream().wait_stream(stream)
        self.grads = [p.grad for p in params]
        after = _counts()
        self.counted = {k: v - before.get(k, 0) for k, v in after.items()}
        _set_counts({k: before.get(k, 0) for k in after})

    def replay(self, batch: Dict[str, torch.Tensor], params: List[torch.Tensor]) -> torch.Tensor:
        """The step on ``batch``: a copy of ``output``."""
        for k, t in self.inputs.items():
            t.copy_(batch[k])
        if any(p.grad is not g for p, g in zip(params, self.grads)):
            for p, g in zip(params, self.grads):     # an eager step came between
                p.grad = g
        opened = []
        for item in self.items:
            if item is None:
                opened.pop().__exit__(None, None, None)
            elif isinstance(item, tuple):
                opened.append(span(item[0], **item[1]))
                opened[-1].__enter__()
            else:
                item.replay()
        return self.output.clone()


def make_train_step(cfg, model: MaskFormer, optimizer: ClippedAdamW,
                    accum_steps: int = 1, mode: str = "averaged", layout=None,
                    apply_fn: Optional[Callable] = None
                    ) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """Build ``train_step(batch) -> metrics`` updating ``model`` in place.

    batch: {"image": [B, H, W, 3] uint8 or float, "gt_masks": [B, M, Hm, Wm],
    "gt_valid": [B, M] bool, "labels": [B] int}, tensors on the model's
    device.  ``grad_norm`` is the global norm before clipping.

    :param layout: a ``parallel.fsdp.StateLayout`` of ``model`` over a data
        mesh, whose ``tensors`` ``optimizer`` steps on; the batch is then
        this rank's rows (``parallel.mesh.batch_sharding``).
    :param apply_fn: ``(model, x, train=) -> outputs`` in place of the
        model's forward: a model-sharding layout's (``parallel/``,
        ``make_tp_apply`` and the others), ``layout`` holding its shards."""
    if mode not in ("averaged", "exact"):
        raise ValueError(f"grad_accum mode must be 'averaged' or 'exact', "
                         f"got {mode!r}")
    compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                     else torch.float32)
    mesh = None if layout is None else layout.mesh

    def forward(batch):
        with span("forward"):
            x = batch["image"]
            if x.dtype == torch.uint8:
                x = normalize_device(x)
            with batch_over(mesh) if mesh is not None else contextlib.nullcontext():
                if apply_fn is not None:
                    return apply_fn(model, x.to(compute_dtype), train=True)
                return model(x.to(compute_dtype), train=True)

    def loss_fn(batch):
        out = forward(batch)
        with span("criterion"):
            res = criterion_forward(
                out["mask_pred"].float(), batch["gt_masks"].float(),
                batch["gt_valid"], out.get("objectness"),
                use_classification_loss=not cfg.use_binary_classifier,
                features=out["features"].float(),
                feature_labels=batch.get("labels"),
                weight_contrastive_loss=cfg.weight_contrastive_loss,
                temperature=cfg.temperature, mesh=mesh)
        return res["loss"], res, out.get("batch_stats", {})

    def backward(loss: torch.Tensor) -> None:
        with span("backward"):
            loss.backward()                       # sums into .grad

    def all_reduce(t: torch.Tensor) -> torch.Tensor:
        if mesh is not None:
            with span("grad_sync"):
                dist.all_reduce(t, group=data_group(mesh))
        return t

    def global_rows(local: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of ``local`` (no gradient), in the global batch's
        order: rank r's row j is global row ``batch_sharding(.., rank=r)[j]``."""
        if mesh is None:
            return local
        n, rows = data_size(mesh), local.shape[0]
        gathered = local.new_empty((n * rows,) + tuple(local.shape[1:]))
        all_gather_into(gathered, local.contiguous(), group=data_group(mesh))
        order = np.concatenate([batch_sharding(mesh, n * rows, accum_steps, rank=r)
                                for r in range(n)])
        out = torch.empty_like(gathered)
        out[torch.as_tensor(order, device=out.device)] = gathered
        return out

    def own_rows(global_t: torch.Tensor) -> torch.Tensor:
        if mesh is None:
            return global_t
        rows = batch_sharding(mesh, global_t.shape[0], accum_steps)
        return global_t[torch.as_tensor(rows, device=global_t.device)]

    def split(batch):
        return [{key: v.chunk(accum_steps)[k] for key, v in batch.items()}
                for k in range(accum_steps)]

    def exact_pass(batch):
        """Both passes of the exact mode; the summed gradients land in
        ``.grad``.  Returns (loss, diagnostics, BN statistics)."""
        micro = split(batch)
        img_valid = batch["gt_valid"].any(dim=1)
        n_total = all_reduce(img_valid.sum()).clamp(min=1).float()
        w_c = cfg.weight_contrastive_loss
        g_z = None
        con_scaled = con_raw = torch.zeros((), device=img_valid.device)
        if w_c != 0.0 and "labels" in batch:
            # pass 1: the whole (global) batch's features, without gradients
            with torch.no_grad():
                z = global_rows(torch.cat([forward(mb)["features"].float()
                                           for mb in micro]))
            z.requires_grad_(True)
            with span("criterion"):
                con_scaled = w_c * contrastive_loss(
                    z, global_rows(batch["labels"]), cfg.temperature,
                    valid=global_rows(img_valid)) / n_total
            # the guards (fewer than two valid rows) return a constant 0
            with span("backward"):
                g_z = (torch.autograd.grad(con_scaled, z)[0] if con_scaled.requires_grad
                       else torch.zeros_like(z))
            con_scaled = con_scaled.detach()
            con_raw = con_scaled * n_total / w_c
            g_z = own_rows(g_z).chunk(accum_steps)
        # pass 2: main loss + the cached feature gradient, with gradients
        main_total = torch.zeros((), device=img_valid.device)
        diag = {key: torch.zeros((), device=img_valid.device) for key in
                ("avg_dice_loss", "avg_ranking_loss", "avg_classification_loss",
                 "avg_iou")}
        all_stats = []
        for k, mb in enumerate(micro):
            out = forward(mb)
            with span("criterion"):
                res = criterion_forward(
                    out["mask_pred"].float(), mb["gt_masks"].float(), mb["gt_valid"],
                    out.get("objectness"),
                    use_classification_loss=not cfg.use_binary_classifier)
                # the criterion normalises by the micro-batch's valid count
                nk = mb["gt_valid"].any(dim=1).sum().clamp(min=1)
                main_sum = res["avg_loss"] * nk
                surrogate = main_sum / n_total
                if g_z is not None:
                    surrogate = surrogate + (out["features"].float() * g_z[k]).sum()
            backward(surrogate)
            main_total = main_total + main_sum.detach()
            for key in diag:
                diag[key] = diag[key] + res[key].detach().float() * nk
            all_stats.append(out.get("batch_stats", {}))
        sums = all_reduce(torch.stack([main_total] + [diag[k] for k in _DIAG]))
        res = {key: v / n_total for key, v in zip(_DIAG, sums[1:])}
        res["avg_contrastive_loss"] = con_raw
        return sums[0] / n_total + con_scaled, res, all_stats

    def mean_stats(all_stats):
        return {name: {s: torch.stack([st[name][s] for st in all_stats]).mean(0)
                       for s in ("mean", "var")}
                for name in all_stats[0]}

    def reduced(loss, res):
        """(loss, diagnostics) of the global batch from this rank's shares
        (``criterion_forward(mesh=)``); as they are without a mesh."""
        if mesh is None:
            return loss, res
        sums = all_reduce(torch.stack([res[k].detach().float()
                                       for k in ("avg_loss",) + _DIAG]))
        out = dict(zip(_DIAG, sums[1:]))
        out["avg_contrastive_loss"] = res["avg_contrastive_loss"]
        # this rank's loss (its main share and the whole contrastive term)
        # plus the other ranks' main shares
        return loss.detach() + (sums[0] - res["avg_loss"].detach()), out

    def param_grads():
        if layout is None:
            return optimizer.grads()
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in layout.params]

    graph: Optional[_Graphed] = None
    eager_signature = None          # of the last eager call

    def train_step(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        global graphed_steps, eager_steps
        nonlocal graph, eager_signature
        sig = (_graph_signature(model, batch)
               if layout is None and apply_fn is None and accum_steps == 1 else None)
        if sig is not None and graph is None and sig == eager_signature:
            graph = capture(batch, sig)
        rows = batch["image"].shape[0]
        if sig is not None and graph is not None and sig == graph.signature:
            with span("step", rows=rows, micro=accum_steps, graphed=1):
                optimizer.advance()
                out = graph.replay(batch, optimizer.params)
            graphed_steps += 1
            _set_counts({k: v + graph.counted.get(k, 0) for k, v in _counts().items()})
            return dict(zip(METRIC_KEYS, out.unbind()))
        eager_signature = sig
        with span("step", rows=rows, micro=accum_steps, graphed=0):
            out = one_step(batch)
        eager_steps += 1
        return out

    def capture(batch, sig) -> _Graphed:
        """The step captured on ``batch``'s signature; the optimizer's count
        stays as it was."""
        with torch.cuda.device(optimizer.params[0].device):
            optimizer.zero_grad()           # the captured backward writes them fresh
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()        # the eager steps' blocks, before the graphs' pool
            return _Graphed(sig, stacked_step, batch, optimizer.params)

    def stacked_step(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        out = one_step(batch, captured=True)
        return torch.stack([out[k] for k in METRIC_KEYS])

    def one_step(batch: Dict[str, torch.Tensor], captured: bool = False
                 ) -> Dict[str, torch.Tensor]:
        """The step; ``captured``: the optimizer's update without its count,
        which the replay advances."""
        if layout is None:
            optimizer.zero_grad()
        else:
            with span("grad_sync"):
                layout.gather()                   # fsdp="full": the whole weights
            model.zero_grad(set_to_none=True)
        if accum_steps > 1 and mode == "exact":
            loss, res, all_stats = exact_pass(batch)
            stats = mean_stats(all_stats)
        elif accum_steps <= 1:
            loss, res, stats = loss_fn(batch)
            backward(loss)
            loss, res = reduced(loss, res)
        else:
            losses, all_res, all_stats = [], [], []
            for micro in split(batch):
                loss_k, res_k, stats_k = loss_fn(micro)
                backward(loss_k)
                loss_k, res_k = reduced(loss_k, res_k)
                losses.append(loss_k.detach())
                all_res.append(res_k)
                all_stats.append(stats_k)
            loss = torch.stack(losses).sum() / accum_steps
            res = {key: torch.stack([r[key].float() for r in all_res]).mean()
                   for key in _DIAG + ("avg_contrastive_loss",)}
            stats = mean_stats(all_stats)
        with span("optimizer"):
            if accum_steps > 1 and mode == "averaged":
                torch._foreach_div_(param_grads(), accum_steps)
            if layout is None:
                grad_norm = global_norm(optimizer.grads())
                if captured:
                    optimizer.update(grad_norm)
                else:
                    optimizer.step(grad_norm)
            else:
                with span("grad_sync"):
                    grads = layout.reduce_grads()
                grad_norm = layout.grad_norm(grads)
                optimizer.step(grad_norm, grads=grads)
                with span("grad_sync"):
                    layout.publish()
            if stats:
                merge_bn_stats(model.encoder, stats)
        return {"loss": loss.detach(),
                "dice_loss": res["avg_dice_loss"].detach(),
                "ranking_loss": res["avg_ranking_loss"].detach(),
                "classification_loss": res["avg_classification_loss"].detach(),
                "contrastive_loss": res["avg_contrastive_loss"].detach(),
                "iou": res["avg_iou"].detach(),
                "grad_norm": grad_norm}

    return train_step


def make_eval_step(cfg, model: MaskFormer, apply_fn: Optional[Callable] = None,
                   fused: bool = True
                   ) -> Callable[[torch.Tensor], Dict[str, torch.Tensor]]:
    """Build ``eval_step(image) -> {"mask_pred": [B, Q, h, w], "objectness":
    [B, Q]}``, the last decoder layer's, both f32 (twin of ``sod_tpu``'s
    ``make_eval_step``).  ``image``: [B, H, W, 3] uint8 (normalised on the
    device) or normalised floats, on the model's device.

    :param fused: the encoder through the fused inference path (K1), as the
        service runs it; an f32 ``compute_dtype`` runs it unfused.
    :param apply_fn: ``(model, x) -> outputs`` in place of the model's
        forward (``fused`` unread): the same forward as the train step's
        under a model-sharding layout (``parallel/``), which the Trainer's
        visualizer hook runs on the rank's whole batch."""
    compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                     else torch.float32)

    def eval_step(image: torch.Tensor) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            if image.dtype == torch.uint8:
                image = normalize_device(image)
            if apply_fn is not None:
                out = apply_fn(model, image.to(compute_dtype))
            else:
                out = model(image.to(compute_dtype), fused=fused)
            return {"mask_pred": out["mask_pred"][:, -1].float(),
                    "objectness": out["objectness"][:, -1, :, 0].float()}

    return eval_step
