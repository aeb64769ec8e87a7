"""Weights into the port (``sod_tpu`` parameter trees and torch
checkpoints) and out of it (``save_torch_checkpoint``, the reference's file).

The port's modules use the reference's ``selfmask_nq20.pt`` key layout, so
a real checkpoint loads with ``load_state_dict`` as it is, and a
``sod_tpu`` tree goes through ``state_dict_from_jax`` (its int8 blocks
through ``blocks_q_from_jax``).  numpy only: no jax and no ``sod_tpu``
import.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Optional

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


def vit_state_dict_from_jax(enc: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A ``sod_tpu`` ViT tree -> the DINO ``deit_small`` state-dict arrays
    (``sod_tpu.models.convert.export_vit``'s keys and arrays)."""
    out: Dict[str, np.ndarray] = {}
    pw = np.asarray(enc["patch_embed"]["w"])         # (p*p*c, D), rows (py, px, c)
    d = pw.shape[1]
    p = int(round((pw.shape[0] // 3) ** 0.5))
    out[prefix + "patch_embed.proj.weight"] = np.ascontiguousarray(
        pw.reshape(p, p, 3, d).transpose(3, 2, 0, 1))
    out[prefix + "patch_embed.proj.bias"] = np.asarray(enc["patch_embed"]["b"])
    out[prefix + "cls_token"] = np.asarray(enc["cls_token"])
    out[prefix + "pos_embed"] = np.asarray(enc["pos_embed"])
    out.update(vit_blocks_from_jax(enc["blocks"], prefix + "blocks."))
    _ln(out, prefix + "norm", enc["norm"])
    return out


def deit_state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A ``sod_tpu`` distilled-DeiT tree -> timm's state-dict arrays."""
    out = vit_state_dict_from_jax(params)
    out["dist_token"] = np.asarray(params["dist_token"])
    for head in ("head", "head_dist"):
        if head in params:
            _linear(out, head, params[head])
    return out


def _conv_oihw(w) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(w).transpose(3, 2, 0, 1))   # HWIO -> OIHW


def _bn(out: dict, prefix: str, p: dict) -> None:
    out[f"{prefix}.weight"] = np.asarray(p["scale"])
    out[f"{prefix}.bias"] = np.asarray(p["bias"])
    out[f"{prefix}.running_mean"] = np.asarray(p["mean"])
    out[f"{prefix}.running_var"] = np.asarray(p["var"])


def resnet_state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A ``sod_tpu`` ResNet tree (any family member, either stem) ->
    torchvision's state-dict arrays: convolutions HWIO -> OIHW, BN
    scale / bias / mean / var -> weight, bias, running_mean, running_var,
    ``down_conv`` / ``down_bn`` -> ``downsample.0`` / ``downsample.1``."""
    out: Dict[str, np.ndarray] = {}
    for name, p in params["prefix"].items():
        if name.startswith("conv"):
            out[f"{name}.weight"] = _conv_oihw(p)
        else:
            _bn(out, name, p)
    for li in range(1, 5):
        blocks = params[f"layer{li}"]
        for b in range(len(blocks)):
            blk, pre = blocks[f"block{b}"], f"layer{li}.{b}"
            for name, p in blk.items():
                key = {"down_conv": "downsample.0", "down_bn": "downsample.1"}.get(name, name)
                if "conv" in name:
                    out[f"{pre}.{key}.weight"] = _conv_oihw(p)
                else:
                    _bn(out, f"{pre}.{key}", p)
    return out


def state_dict_from_jax(params: dict) -> Dict[str, np.ndarray]:
    """A ``sod_tpu`` MaskFormer tree (numpy leaves, e.g. from
    ``jax.device_get``) -> the reference's state-dict arrays: the same
    keys and arrays as ``sod_tpu.models.convert.export_maskformer`` for the
    ViT encoder, either head.  For the ResNet-50 encoder (a tree with a
    ``prefix`` stem) the layout is the port's own, since ``sod_tpu``'s
    export has no ResNet branch: ``encoder.`` before torchvision's names
    (``resnet_state_dict_from_jax``) and ``linear_layer.{weight,bias}`` an
    (out, in) linear."""
    if "prefix" in params["encoder"]:
        out = {f"encoder.{k}": v
               for k, v in resnet_state_dict_from_jax(params["encoder"]).items()}
        _linear(out, "linear_layer", params["linear_layer"])
    else:
        out = vit_state_dict_from_jax(params["encoder"], "encoder.")

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


def require_torch_checkpoint(path: str) -> None:
    """The port's one rule for a weights path given by a user: a torch
    checkpoint file (``.pt``/``.pth``/``.tar``), which ``sod_tpu`` loads with
    ``torch.load`` too; anything else is what ``sod_tpu`` restores with orbax,
    which is not ported."""
    if not path.endswith((".pt", ".pth", ".tar")):
        raise NotImplementedError(
            f"{path!r}: the port loads torch checkpoints only; orbax "
            "checkpoint directories are not ported (ROADMAP item 13)")


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """Tensors of a torch checkpoint on the CPU; unwraps the reference's
    ``{'model': state_dict}`` (and ``state_dict`` / ``teacher``) nesting.
    Loads with ``weights_only=True``: tensors and plain containers only."""
    return state_dict_of(torch.load(path, map_location="cpu", weights_only=True))


def state_dict_of(obj) -> Dict[str, torch.Tensor]:
    """The tensors of a loaded checkpoint, unwrapped as
    ``load_torch_state_dict`` unwraps them."""
    for key in ("model", "state_dict", "teacher"):
        if isinstance(obj, dict) and isinstance(obj.get(key), dict):
            obj = obj[key]
            break
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def save_torch_checkpoint(path: str, state_dict: Mapping[str, torch.Tensor],
                          extra: Optional[Dict] = None) -> str:
    """Write ``{'model': state_dict}`` exactly as the reference's consumers
    expect (``app.py:185-187`` pops ``['model']``), ``extra`` beside it, as
    ``sod_tpu``'s ``save_torch_checkpoint`` does.  fp32 tensors on the CPU:
    bf16 weights are upcast, matching torch's default dtype."""
    sd = {k: (v.detach().cpu().float() if v.is_floating_point() else v.detach().cpu())
          for k, v in state_dict.items()}
    obj = {"model": sd}
    if extra:
        obj.update(extra)
    torch.save(obj, path)
    return path


# ---------------------------------------------------------------------------
# torch checkpoints of the pseudo-mask backbones: the layout is already the
# port's, so these strip wrappers and check keys (``sod_tpu`` converts
# layouts here, ``sod_tpu/models/convert.py:68,271,298``)
# ---------------------------------------------------------------------------

_RESNET_PREFIXES = ("module.encoder_q.", "module.", "encoder_q.", "network.")


def _strip_resnet_prefix(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """MoCo-v2 / SwAV / torchvision / reference naming -> torchvision's:
    the first wrapper prefix and the reference's ``prefix.`` stem stripped,
    the heads and ``num_batches_tracked`` dropped."""
    out = {}
    for k, v in sd.items():
        for p in _RESNET_PREFIXES:
            if k.startswith(p):
                k = k[len(p):]
                break
        if any(w in k for w in ("fc.", "projection_head", "prototypes",
                                "num_batches_tracked")):
            continue
        out[k.replace("prefix.", "")] = v
    return out


def _require(sd: Mapping[str, Any], keys, what: str) -> None:
    missing = [k for k in keys if k not in sd]
    if missing:
        raise KeyError(f"{what}: {len(missing)} keys missing, e.g. {missing[:5]}")


def convert_vit(sd: Mapping[str, Any], depth: int = 12, prefix: str = "") -> Dict[str, Any]:
    """A DINO ``deit_small``-named state dict -> the keys of the port's
    ``VisionTransformer`` (``prefix`` stripped); ``KeyError`` when one is
    missing."""
    keys = ["patch_embed.proj.weight", "patch_embed.proj.bias", "cls_token", "pos_embed",
            "norm.weight", "norm.bias"]
    for i in range(depth):
        for m in ("norm1", "attn.qkv", "attn.proj", "norm2", "mlp.fc1", "mlp.fc2"):
            keys += [f"blocks.{i}.{m}.weight", f"blocks.{i}.{m}.bias"]
    sd = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    _require(sd, keys, "ViT state dict")
    return {k: sd[k] for k in keys}


def convert_resnet50(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A MoCo-v2 / SwAV / torchvision ResNet-50 state dict -> the port's
    ``ResNet`` keys (``_strip_resnet_prefix``); ``KeyError`` when one is
    missing."""
    sd = _strip_resnet_prefix(sd)

    def bn(p):
        return [f"{p}.{n}" for n in ("weight", "bias", "running_mean", "running_var")]

    keys = ["conv1.weight", *bn("bn1")]
    for li, n in enumerate((3, 4, 6, 3), start=1):
        for b in range(n):
            p = f"layer{li}.{b}"
            for i in (1, 2, 3):
                keys += [f"{p}.conv{i}.weight", *bn(f"{p}.bn{i}")]
            if b == 0:
                keys += [f"{p}.downsample.0.weight", *bn(f"{p}.downsample.1")]
    _require(sd, keys, "ResNet-50 state dict")
    return {k: sd[k] for k in keys}
