"""Weights into the port: ``sod_tpu`` parameter trees and torch checkpoints.

The port's modules use the reference's ``selfmask_nq20.pt`` key layout, so
a real checkpoint loads with ``load_state_dict`` as it is, and a
``sod_tpu`` tree goes through ``state_dict_from_jax`` (its int8 blocks
through ``blocks_q_from_jax``).  numpy only: no jax and no ``sod_tpu``
import.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


def _t(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a).T)


def _ln(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])


def _linear(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = _t(p["w"])             # (in, out) -> (out, in)
    if "b" in p:
        out[f"{prefix}.bias"] = np.asarray(p["b"])


def _mha(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.in_proj_weight"] = _t(p["in_proj"]["w"])
    if "b" in p["in_proj"]:
        out[f"{prefix}.in_proj_bias"] = np.asarray(p["in_proj"]["b"])
    _linear(out, f"{prefix}.out_proj", p["out_proj"])


def _layer(stacked: dict, i: int) -> dict:
    """Layer ``i`` of a tree stacked along a leading layer axis."""
    return {k: _layer(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in stacked.items()}


def _depth(stacked: dict) -> int:
    leaf = stacked
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return int(np.asarray(leaf).shape[0])


def vit_blocks_from_jax(blocks: dict, prefix: str) -> Dict[str, np.ndarray]:
    """``sod_tpu``'s stacked encoder blocks -> ``{prefix}{i}.norm1.weight``
    ... of the port's ``Block``s."""
    out: Dict[str, np.ndarray] = {}
    for i in range(_depth(blocks)):
        bp, pre = _layer(blocks, i), f"{prefix}{i}."
        _ln(out, pre + "norm1", bp["norm1"])
        _linear(out, pre + "attn.qkv", bp["attn"]["qkv"])
        _linear(out, pre + "attn.proj", bp["attn"]["proj"])
        _ln(out, pre + "norm2", bp["norm2"])
        _linear(out, pre + "mlp.fc1", bp["mlp"]["fc0"])
        _linear(out, pre + "mlp.fc2", bp["mlp"]["fc1"])
    return out


def state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A ``sod_tpu`` MaskFormer tree (numpy leaves, e.g. from
    ``jax.device_get``) -> the reference's state-dict arrays: the same
    keys and arrays as ``sod_tpu.models.convert.export_maskformer``."""
    out: Dict[str, np.ndarray] = {}
    enc = params["encoder"]
    pw = np.asarray(enc["patch_embed"]["w"])         # (p*p*c, D), rows (py, px, c)
    d = pw.shape[1]
    p = int(round((pw.shape[0] // 3) ** 0.5))
    out["encoder.patch_embed.proj.weight"] = np.ascontiguousarray(
        pw.reshape(p, p, 3, d).transpose(3, 2, 0, 1))
    out["encoder.patch_embed.proj.bias"] = np.asarray(enc["patch_embed"]["b"])
    out["encoder.cls_token"] = np.asarray(enc["cls_token"])
    out["encoder.pos_embed"] = np.asarray(enc["pos_embed"])
    out.update(vit_blocks_from_jax(enc["blocks"], "encoder.blocks."))
    _ln(out, "encoder.norm", enc["norm"])

    dec = params["decoder"]
    for i in range(_depth(dec["layers"])):
        lp, pre = _layer(dec["layers"], i), f"decoder.layers.{i}"
        _mha(out, f"{pre}.self_attn", lp["self_attn"])
        _mha(out, f"{pre}.multihead_attn", lp["cross_attn"])
        _linear(out, f"{pre}.linear1", lp["linear1"])
        _linear(out, f"{pre}.linear2", lp["linear2"])
        for n in ("norm1", "norm2", "norm3"):
            _ln(out, f"{pre}.{n}", lp[n])
    _ln(out, "decoder.norm", dec["norm"])
    out["query_embed"] = np.asarray(params["query_embed"])
    for i in sorted(int(k[2:]) for k in params["ffn"]):
        _linear(out, f"ffn.layers.{i}", params["ffn"][f"fc{i}"])
    if "linear_classifier" in params:                # use_binary_classifier=False
        _linear(out, "linear_classifier", params["linear_classifier"])
        _ln(out, "norm", params["norm"])
    return out


def blocks_q_from_jax(blocks_q: dict) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """``sod_tpu``'s quantised encoder blocks (the stacked ``blocks_q`` tree
    of ``quantize_vit_blocks``, numpy leaves: ``q`` [L, in, out] int8, ``s``
    [L, 1, out], ``b`` [L, out], ``norm1`` / ``norm2`` scale and bias) ->
    the port's per-block records (``ops.fused_block_int8``): codes (out, in),
    scales and biases [out], LayerNorm weight and bias, dtypes kept."""
    def t(a):
        return torch.from_numpy(np.array(a))         # a writable copy

    records = []
    for i in range(_depth(blocks_q)):
        lp = _layer(blocks_q, i)
        rec = {n: {"weight": t(lp[n]["scale"]), "bias": t(lp[n]["bias"])}
               for n in ("norm1", "norm2")}
        for ours, theirs in (("qkv", "qkv"), ("proj", "proj"),
                             ("fc1", "fc0"), ("fc2", "fc1")):
            m = lp[theirs]
            rec[ours] = {"q": t(m["q"].T), "s": t(m["s"].reshape(-1)),
                         "b": t(m["b"])}
        records.append(rec)
    return records


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Tensors of a torch checkpoint on the CPU; unwraps the reference's
    ``{'model': state_dict}`` (and ``state_dict`` / ``teacher``) nesting.
    Loads with ``weights_only=True``: tensors and plain containers only."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "teacher"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}
