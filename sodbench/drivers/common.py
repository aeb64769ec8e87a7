"""What the drivers share: the program's ``Config`` from a configuration
file and a traffic mix's overrides, the weights from the seed, and the
statistics the comparisons take."""
from __future__ import annotations

import dataclasses
import math
import statistics
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import torch

from sodbench.inputs import generator
from sodbench.reference.model import make_weights, param_specs

WEIGHT_STREAM = 0


def program_config(ctx):
    """The program's ``Config``: the configuration file's ``config``, then
    the traffic's ``config_overrides``."""
    from sod_tpu_torch.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    raw = {**ctx.config["config"], **ctx.traffic.get("config_overrides", {})}
    unknown = sorted(set(raw) - fields)
    if unknown:
        raise KeyError(f"keys the program's Config does not have: {unknown}")
    for key in ("scale_range", "micro_batch_buckets"):
        if key in raw and raw[key] is not None:
            raw[key] = tuple(raw[key])
    return Config(**raw)


def weights(ctx, device) -> Dict[str, torch.Tensor]:
    """Every tensor of the model from the seed, f32, on ``device``."""
    c = ctx.config["config"]
    specs = param_specs(c["arch"], c["patch_size"], c["n_queries"], c["n_decoder_layers"])
    return make_weights(specs, generator(ctx.seed, WEIGHT_STREAM, device), device)


def load_libraries(names: List[str], device) -> None:
    """Build (first run only) and load the program's kernel libraries; on
    the CPU the program runs its plain versions and needs none."""
    if not names or torch.device(device).type != "cuda":
        return
    from sod_tpu_torch.ops._build import load

    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(load, names))


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def free(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def rel_gap(a: float, b: float, base: float) -> float:
    return abs(a - b) / base if base > 0 else (0.0 if a == b else math.inf)


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float], over=max, keep=None) -> float:
    """``over`` (the worst, or the median) leaf's |prog norm - ref norm| over
    the larger of the leaf's reference norm and the median leaf's."""
    names = [k for k in ref if keep is None or k in keep]
    med = statistics.median(ref[k] for k in names)
    return over([abs(prog[k] - ref[k]) / max(ref[k], med) for k in names])
