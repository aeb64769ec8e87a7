"""Model factory of the port (twin of ``sod_tpu/models/factory.py``; ref
``utils/misc.py:163-227`` ``get_model``).

Returns (config, module, apply_fn): the port's ``nn.Module`` where
``sod_tpu`` returns a parameter tree, and ``apply_fn(module, x, ...)``.  Weights come from a local torch
checkpoint (``checkpoint=``, read on the CPU) or are drawn from ``seed``
with numpy; nothing is downloaded.
"""
from __future__ import annotations

from typing import Optional

from sod_tpu_torch.models import convert


def get_model(arch: str, patch_size: Optional[int] = None,
              training_method: Optional[str] = None, configs=None,
              checkpoint: Optional[str] = None, seed: int = 0):
    """Build (cfg, module, apply_fn) for ``arch``: "maskformer" (from the
    flat experiment ``configs``, whose ``arch`` picks the encoder),
    "vit_small" / "vit_tiny" / "vit_base", "dinov2_vitg14_reg" (a checkpoint
    in the DINOv2 hub's layout, ``convert.convert_dinov2``), "resnet50" or
    "deit_small_distilled"."""
    if arch == "maskformer":
        if configs is None:
            raise ValueError("arch='maskformer' needs configs")
        from sod_tpu_torch.models.maskformer import (
            MaskFormer,
            config_from,
            random_state_dict,
        )

        mcfg = config_from(configs)
        model = MaskFormer(mcfg)
        model.load_state_dict(convert.load_torch_state_dict(checkpoint) if checkpoint
                              else random_state_dict(model, seed))
        return mcfg, model, MaskFormer.forward

    if arch.startswith("vit") or arch.startswith("deit_small_p"):
        from sod_tpu_torch.models.vit import (
            VisionTransformer,
            random_vit_state_dict,
            vit_apply,
            vit_base,
            vit_small,
            vit_tiny,
        )

        make_cfg = {"vit_tiny": vit_tiny, "vit_base": vit_base}.get(arch, vit_small)
        vcfg = make_cfg(patch_size=patch_size or 16)
        if training_method == "deit":
            raise ValueError(
                "training_method='deit' uses arch='deit_small_distilled' "
                "(the reference's timm path; its MaskFormer cannot consume "
                "it either, see sod_tpu_torch/models/deit.py)")
        model = VisionTransformer(vcfg)
        model.load_state_dict(
            convert.convert_vit(convert.load_torch_state_dict(checkpoint), depth=vcfg.depth)
            if checkpoint else random_vit_state_dict(model, seed))
        return vcfg, model, vit_apply

    if arch == "dinov2_vitg14_reg":
        from sod_tpu_torch.models.vit import (
            VisionTransformer,
            dinov2_vitg14_reg,
            random_vit_state_dict,
            vit_apply,
        )

        vcfg = dinov2_vitg14_reg(patch_size=patch_size or 14)
        model = VisionTransformer(vcfg)
        model.load_state_dict(
            convert.convert_dinov2(convert.load_torch_state_dict(checkpoint), depth=vcfg.depth)
            if checkpoint else random_vit_state_dict(model, seed))
        return vcfg, model, vit_apply

    if arch == "deit_small_distilled":
        from sod_tpu_torch.models.deit import (
            deit_apply,
            deit_init,
            deit_small_distilled_patch16_224,
        )

        dcfg = deit_small_distilled_patch16_224()
        return dcfg, deit_init(dcfg, seed), deit_apply

    if arch == "resnet50":
        if training_method not in ("mocov2", "swav", "supervised", None):
            raise ValueError(f"training_method={training_method!r} for resnet50")
        from sod_tpu_torch.models.resnet import resnet50_apply, resnet50_init

        model = resnet50_init(seed)
        if checkpoint:
            model.load_state_dict(
                convert.convert_resnet50(convert.load_torch_state_dict(checkpoint)))
        return None, model, resnet50_apply

    raise ValueError(
        f"{arch} is not a supported arch. Choose from "
        "[maskformer, vit_small, vit_tiny, vit_base, dinov2_vitg14_reg, resnet50, "
        "deit_small_distilled]")
