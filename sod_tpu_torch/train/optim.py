"""Optimizer of the port (twin of ``sod_tpu/train/optim.py``): optax's
``chain(clip_by_global_norm(1.0), adamw(schedule, b1=0.9, b2=0.999,
eps=1e-8, weight_decay))`` on torch parameters, with optax's semantics:

* the clip scales by ``1 / ||g||`` (then ``* max_norm``) only when
  ``||g|| >= max_norm``, with no ``+1e-6`` (unlike ``clip_grad_norm_``);
* Adam's eps sits outside the square root of the bias-corrected second
  moment;
* weight decay applies to every parameter (optax's mask is None: LayerNorm
  scales, biases, ``pos_embed``, ``cls_token`` and ``query_embed`` too);
* the learning rate is the schedule at optax's count, which is 0 at the
  first update.

The update runs as ``torch._foreach_*`` ops over all parameters, on the
device, with no host synchronisation; the schedule is evaluated on the host
from the Python step count.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional

import torch

from sod_tpu_torch.train.lr_schedule import poly_schedule


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``),
    as a 0-d f32 tensor on the tensors' device."""
    norms = torch._foreach_norm(tensors, 2)
    return torch.stack(norms).float().square().sum().sqrt()


class ClippedAdamW:
    """clip_by_global_norm + AdamW with optax's update order:
    ``g = clip(g)``; ``mu = (1-b1) g + b1 mu``; ``nu = (1-b2) g^2 + b2 nu``;
    ``u = (mu / (1-b1^t)) / (sqrt(nu / (1-b2^t)) + eps) + wd p``;
    ``p = p - lr(t-1) u``."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 schedule: Callable[[int], float], b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, max_norm: float = 1.0):
        self.params = list(params)
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    def grads(self) -> List[torch.Tensor]:
        return [p.grad if p.grad is not None else torch.zeros_like(p)
                for p in self.params]

    @torch.no_grad()
    def step(self, grad_norm: Optional[torch.Tensor] = None,
             grads: Optional[List[torch.Tensor]] = None) -> None:
        """One update from the parameters' ``.grad``, or from ``grads`` (one
        per parameter: a data-parallel layout hands the reduced gradients
        of the tensors it steps on, ``parallel/fsdp.py``); ``grad_norm`` is
        the global norm of the whole gradient if the caller has it (it
        must, when ``grads`` are shards)."""
        grads = self.grads() if grads is None else list(grads)
        g_norm = global_norm(grads) if grad_norm is None else grad_norm
        # optax: where(||g|| < max_norm, g, (g / ||g||) * max_norm)
        keep = g_norm < self.max_norm
        one = torch.ones_like(g_norm)
        grads = torch._foreach_div(grads, torch.where(keep, one, g_norm))
        torch._foreach_mul_(grads, torch.where(keep, one, one * self.max_norm))

        b1, b2 = self.b1, self.b2
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(grads, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1 - b2))
        lr = float(self.schedule(self.count))
        self.count += 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** self.count
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** self.count
        mu_hat = torch._foreach_div(self.mu, float(bc1))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, float(bc2)))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        if self.weight_decay:
            torch._foreach_add_(upd, torch._foreach_mul(self.params,
                                                        self.weight_decay))
        torch._foreach_mul_(upd, -lr)
        torch._foreach_add_(self.params, upd)

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": [t.clone() for t in self.mu],
                "nu": [t.clone() for t in self.nu]}

    def load_state_dict(self, state: Dict) -> None:
        """Restore moments and count; a checkpoint from another optimizer or
        model (different leaf count or shapes) raises instead of loading."""
        mu, nu = state["mu"], state["nu"]
        if len(mu) != len(self.mu) or len(nu) != len(self.nu):
            raise ValueError(
                f"checkpoint optimizer state has {len(mu)} moments but the "
                f"current optimizer expects {len(self.mu)}: the model or the "
                "optimizer changed since this checkpoint was written")
        for i, (cur, new) in enumerate(zip(self.mu + self.nu, mu + nu)):
            if cur.shape != new.shape:
                raise ValueError(f"optimizer-state leaf {i} shape mismatch: "
                                 f"checkpoint {tuple(new.shape)} vs current "
                                 f"{tuple(cur.shape)}")
        for cur, new in zip(self.mu + self.nu, mu + nu):
            cur.copy_(new)
        self.count = int(state["count"])


def build_optimizer(cfg, params: Iterable[torch.nn.Parameter],
                    n_iters_per_epoch: int,
                    faithful_lr_cycle: bool = True) -> ClippedAdamW:
    """AdamW + global-norm clip + per-iteration poly schedule.

    :param faithful_lr_cycle: the reference scheduler's per-epoch counter
        wrap (``lr_schedule.py``); True matches the shipped training run."""
    if cfg.optimizer_type != "adamw":
        raise ValueError(f"unsupported optimizer_type {cfg.optimizer_type}")
    schedule = poly_schedule(
        cfg.lr, total_iters=cfg.n_epochs * n_iters_per_epoch,
        warmup_iters=cfg.lr_warmup_duration * n_iters_per_epoch,
        cycle_iters=n_iters_per_epoch if faithful_lr_cycle else None)
    return ClippedAdamW(params, schedule, b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=cfg.weight_decay, max_norm=1.0)


def get_lr_scheduler(cfg, n_iters_per_epoch: int, mode: str = "poly",
                     **kwargs) -> Callable[[int], float]:
    """Scheduler factory (ref ``utils/misc.py:154-160``; poly only): the
    poly schedule over ``cfg.n_epochs`` epochs with ``cfg.lr_warmup_duration``
    warmup epochs; ``kwargs`` go to ``poly_schedule``."""
    if mode != "poly":
        raise ValueError(
            f"Unsupported lr scheduler type: {mode} (currently [poly] "
            "supported)")
    return poly_schedule(cfg.lr, total_iters=cfg.n_epochs * n_iters_per_epoch,
                         warmup_iters=cfg.lr_warmup_duration * n_iters_per_epoch,
                         **kwargs)
