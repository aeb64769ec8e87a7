"""ResNet backbones of the port (twin of ``sod_tpu/models/resnet.py``).

The reference's stack (``networks/resnet.py``, ``resnet_backbone.py``,
``resnet_models.py``): the 7x7/2 stem with BN, relu and a 3x3/2 max pool
(or the deep-base stem of three 3x3 convs), v1.5 bottlenecks (the stride on
the 3x3) or basic blocks, and the dilated variants of ``_nostride_dilate``:
``dilate_scale=8`` (the pseudo-mask backbone: layer3 unstrided at dilation
2, layer4 at 4, res5 at 1/8 of the input), 16, or None (stride 32).

Modules carry torchvision's key names (``conv1.weight``, ``bn1.running_mean``,
``layer1.0.downsample.0.weight``, ...), so a MoCo-v2, SwAV or torchvision
state dict loads as it is after ``models.convert.convert_resnet50``.  The
public functions keep ``sod_tpu``'s layout: images NHWC [B, H, W, 3], stage
outputs NHWC (views of the NCHW tensors the convolutions produce).

Arithmetic as ``sod_tpu``'s: convolutions in the input's dtype with f32
accumulation and one rounding to it (bf16 in the MaskFormer's train step
and service, f32 for the mask generator); inference BN folded into a scale
and a bias in f32 (``scale = weight * rsqrt(var + eps)``, ``bias - mean *
scale``), cast back once; train-mode BN in f32 by the batch's biased
variance, the running statistics updated with the unbiased one at
``momentum``.  cuDNN would run an f32 convolution in TF32 by default: a
caller that wants f32 on the card turns ``torch.backends.cudnn.allow_tf32``
off around the forward (the mask generator does).  ``conv_init``,
``bn_init`` and ``resnet_state_init`` draw ``sod_tpu``'s init from a
``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

RESNET50_OUT_CHANNELS = 2048
_PLANES = (64, 128, 256, 512)
_FAMILY = {
    "resnet18": ("basic", (2, 2, 2, 2)),
    "resnet34": ("basic", (3, 4, 6, 3)),
    "resnet50": ("bottleneck", (3, 4, 6, 3)),
    "resnet101": ("bottleneck", (3, 4, 23, 3)),
    "resnet152": ("bottleneck", (3, 8, 36, 3)),
}


class BatchNorm(nn.Module):
    """torch ``BatchNorm2d``'s parameters and buffers (eps 1e-5), applied by
    ``batch_norm`` / ``batch_norm_train``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))


def conv(weight: torch.Tensor, x: torch.Tensor, stride: int = 1,
         dilation: int = 1) -> torch.Tensor:
    """NCHW convolution with an OIHW weight, padding dilation * (k - 1) / 2."""
    pad = dilation * (weight.shape[-1] - 1) // 2
    return F.conv2d(x, weight.to(x.dtype), stride=stride, padding=pad, dilation=dilation)


def batch_norm(bn: BatchNorm, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Inference BN on NCHW x with the running statistics, folded in f32."""
    scale = bn.weight.float() * torch.rsqrt(bn.running_var.float() + eps)
    bias = bn.bias.float() - bn.running_mean.float() * scale
    return (x.float() * scale[:, None, None] + bias[:, None, None]).to(x.dtype)


def batch_norm_train(bn: BatchNorm, x: torch.Tensor, eps: float = 1e-5,
                     momentum: float = 0.1):
    """Train-mode BN on NCHW x: normalise by the batch's biased variance.

    :return: (y, {"mean": new running mean, "var": new running var}), the
        running variance updated with the unbiased batch variance."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = xf.var(dim=(0, 2, 3), unbiased=False)
    inv = torch.rsqrt(var + eps)
    y = ((xf - mean[:, None, None]) * inv[:, None, None] * bn.weight.float()[:, None, None]
         + bn.bias.float()[:, None, None]).to(x.dtype)
    n = x.shape[0] * x.shape[2] * x.shape[3]
    unbiased = var * (n / max(n - 1, 1))
    new = {"mean": ((1 - momentum) * bn.running_mean.float() + momentum * mean.detach()
                    ).to(bn.running_mean.dtype),
           "var": ((1 - momentum) * bn.running_var.float() + momentum * unbiased.detach()
                   ).to(bn.running_var.dtype)}
    return y, new


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """torch ``MaxPool2d(3, 2, padding=1)`` on NCHW x (padding is -inf)."""
    return F.max_pool2d(x, 3, 2, 1)


def _conv_weight(rng: Optional[np.random.Generator], cout: int, cin: int,
                 k: int) -> torch.Tensor:
    """He-normal N(0, sqrt(2 / (k * k * cout))), the reference's init;
    uninitialised without ``rng``."""
    if rng is None:
        return torch.empty(cout, cin, k, k)
    return torch.from_numpy(
        (rng.standard_normal((cout, cin, k, k)) * math.sqrt(2.0 / (k * k * cout))
         ).astype(np.float32))


class _Conv(nn.Module):
    """Holds a bias-free conv weight under torchvision's name ``weight``."""

    def __init__(self, weight: torch.Tensor):
        super().__init__()
        self.weight = nn.Parameter(weight)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, rng, cin: int, planes: int, has_down: bool):
        super().__init__()
        self.conv1 = _Conv(_conv_weight(rng, planes, cin, 1))
        self.bn1 = BatchNorm(planes)
        self.conv2 = _Conv(_conv_weight(rng, planes, planes, 3))
        self.bn2 = BatchNorm(planes)
        self.conv3 = _Conv(_conv_weight(rng, planes * 4, planes, 1))
        self.bn3 = BatchNorm(planes * 4)
        if has_down:
            self.downsample = nn.Sequential(_Conv(_conv_weight(rng, planes * 4, cin, 1)),
                                            BatchNorm(planes * 4))

    def forward(self, x, stride: int, dil_strided: int, dil_rest: int, bn):
        """The strided 3x3 (conv2) carries ``dil_strided`` (the 1x1s never
        dilate)."""
        out = F.relu(bn("bn1", self.bn1, conv(self.conv1.weight, x)))
        out = F.relu(bn("bn2", self.bn2, conv(self.conv2.weight, out, stride, dil_strided)))
        out = bn("bn3", self.bn3, conv(self.conv3.weight, out))
        residual = x
        if hasattr(self, "downsample"):
            residual = bn("downsample.1", self.downsample[1],
                          conv(self.downsample[0].weight, x, stride))
        return F.relu(out + residual)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, rng, cin: int, planes: int, has_down: bool):
        super().__init__()
        self.conv1 = _Conv(_conv_weight(rng, planes, cin, 3))
        self.bn1 = BatchNorm(planes)
        self.conv2 = _Conv(_conv_weight(rng, planes, planes, 3))
        self.bn2 = BatchNorm(planes)
        if has_down:
            self.downsample = nn.Sequential(_Conv(_conv_weight(rng, planes, cin, 1)),
                                            BatchNorm(planes))

    def forward(self, x, stride: int, dil_strided: int, dil_rest: int, bn):
        """The originally strided conv1 carries ``dil_strided``, conv2 the
        stage's full dilation (``resnet_backbone.py:43-88``)."""
        out = F.relu(bn("bn1", self.bn1, conv(self.conv1.weight, x, stride, dil_strided)))
        out = bn("bn2", self.bn2, conv(self.conv2.weight, out, 1, dil_rest))
        residual = x
        if hasattr(self, "downsample"):
            residual = bn("downsample.1", self.downsample[1],
                          conv(self.downsample[0].weight, x, stride))
        return F.relu(out + residual)


class ResNet(nn.Module):
    """Stem, then ``layer1`` .. ``layer4`` of blocks ``0`` .. ``n - 1``.
    ``seed=None`` leaves the convolutions uninitialised, for a state dict to
    fill."""

    def __init__(self, arch: str = "resnet50", deep_base: bool = False,
                 seed: Optional[int] = 0):
        super().__init__()
        block_type, layers = _FAMILY[arch]
        self.arch, self.block_type = arch, block_type
        rng = None if seed is None else np.random.default_rng(seed)
        if deep_base:
            self.conv1 = _Conv(_conv_weight(rng, 64, 3, 3))
            self.bn1 = BatchNorm(64)
            self.conv2 = _Conv(_conv_weight(rng, 64, 64, 3))
            self.bn2 = BatchNorm(64)
            self.conv3 = _Conv(_conv_weight(rng, 128, 64, 3))
            self.bn3 = BatchNorm(128)
            cin = 128
        else:
            self.conv1 = _Conv(_conv_weight(rng, 64, 3, 7))
            self.bn1 = BatchNorm(64)
            cin = 64
        block = Bottleneck if block_type == "bottleneck" else BasicBlock
        for i, (n_blocks, planes) in enumerate(zip(layers, _PLANES)):
            blocks = []
            for b in range(n_blocks):
                has_down = b == 0 and (i != 0 or cin != planes * block.expansion)
                blocks.append(block(rng, cin, planes, has_down))
                cin = planes * block.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))


def conv_init(gen: torch.Generator, kh: int, kw: int, cin: int, cout: int) -> torch.Tensor:
    """``sod_tpu``'s ``conv_init`` drawn from ``gen``: He-normal
    N(0, sqrt(2 / (kh * kw * cout))), in the torch layout (cout, cin, kh, kw)."""
    return torch.randn(cout, cin, kh, kw, generator=gen) * math.sqrt(2.0 / (kh * kw * cout))


def bn_init(c: int) -> Dict[str, torch.Tensor]:
    """``sod_tpu``'s ``bn_init``: BN at the identity, under torch's names."""
    return {"weight": torch.ones(c), "bias": torch.zeros(c),
            "running_mean": torch.zeros(c), "running_var": torch.ones(c)}


def resnet_state_init(model: ResNet, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A state dict for ``model`` (any family member, either stem) drawn from
    ``gen`` by ``conv_init`` and ``bn_init``, in module order."""
    out: Dict[str, torch.Tensor] = {}
    for name, mod in model.named_modules():
        if isinstance(mod, _Conv):
            cout, cin, kh, kw = mod.weight.shape
            out[f"{name}.weight"] = conv_init(gen, kh, kw, cin, cout)
        elif isinstance(mod, BatchNorm):
            out.update({f"{name}.{k}": v for k, v in bn_init(mod.weight.shape[0]).items()})
    return out


def resnet_init(arch: str = "resnet50", deep_base: bool = False, seed: int = 0) -> ResNet:
    """Any member of the family with seeded He-normal convolutions (numpy;
    ``sod_tpu`` draws with ``jax.random``, so the values differ) and BN at
    the identity."""
    return ResNet(arch, deep_base, seed)


def resnet50_init(seed: int = 0) -> ResNet:
    """ResNet-50; dilation is a property of the forward, not of the weights."""
    return ResNet("resnet50", seed=seed)


def _stage_geometry(dilate_scale: Optional[int]):
    """{stage: (first block's stride, its dilation, the rest's dilation)},
    the reference's ``_nostride_dilate`` with multi_grid=None."""
    geo = {}
    for i in range(4):
        first_stride, first_dil, rest_dil = (1 if i == 0 else 2), 1, 1
        if dilate_scale == 8:
            if i == 2:
                first_stride, first_dil, rest_dil = 1, 1, 2
            if i == 3:
                first_stride, first_dil, rest_dil = 1, 2, 4
        elif dilate_scale == 16 and i == 3:
            first_stride, first_dil, rest_dil = 1, 1, 2
        geo[i] = (first_stride, first_dil, rest_dil)
    return geo


def resnet_forward(model: ResNet, x: torch.Tensor, dilate_scale: Optional[int] = 8,
                   train: bool = False, momentum: float = 0.1,
                   stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """NCHW forward: {"res2": .., "res5": ..} NCHW.

    :param train: batch-statistics BN; ``stats`` (a dict) then receives
        ``{bn name: {"mean", "var"}}`` for every BN, keyed by its module
        path (``layer1.0.bn1``, ``layer1.0.downsample.1``, ``bn1``), for
        ``merge_bn_stats``."""
    stats = {} if stats is None else stats

    def bn_at(prefix):
        def bn(name, mod, h):
            if not train:
                return batch_norm(mod, h)
            y, stats[prefix + name] = batch_norm_train(mod, h, momentum=momentum)
            return y
        return bn

    stem = bn_at("")
    h = F.relu(stem("bn1", model.bn1, conv(model.conv1.weight, x, stride=2)))
    if hasattr(model, "conv2"):                          # deep-base stem
        h = F.relu(stem("bn2", model.bn2, conv(model.conv2.weight, h)))
        h = F.relu(stem("bn3", model.bn3, conv(model.conv3.weight, h)))
    h = max_pool_3x3_s2(h)
    outs = {}
    for i, (first_stride, first_dil, rest_dil) in _stage_geometry(dilate_scale).items():
        for b, blk in enumerate(getattr(model, f"layer{i + 1}")):
            h = blk(h, first_stride if b == 0 else 1, first_dil if b == 0 else rest_dil,
                    rest_dil, bn_at(f"layer{i + 1}.{b}."))
        outs[f"res{i + 2}"] = h
    return outs


def resnet_apply(model: ResNet, x: torch.Tensor, dilate_scale: Optional[int] = 8,
                 train: bool = False, momentum: float = 0.1,
                 stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    """``sod_tpu``'s layout: x [B, H, W, 3] normalised, res2..res5 NHWC."""
    outs = resnet_forward(model, x.permute(0, 3, 1, 2), dilate_scale, train, momentum,
                          stats)
    return {k: v.permute(0, 2, 3, 1) for k, v in outs.items()}


def resnet50_apply(model: ResNet, x: torch.Tensor, dilate_scale: Optional[int] = 8,
                   train: bool = False, momentum: float = 0.1,
                   stats: Optional[dict] = None) -> Dict[str, torch.Tensor]:
    return resnet_apply(model, x, dilate_scale, train, momentum, stats)


@torch.no_grad()
def merge_bn_stats(model: ResNet, stats: dict) -> ResNet:
    """Write the running statistics that a train-mode forward collected
    (``{bn path: {"mean", "var"}}``) into the model's BN buffers."""
    for name, new in stats.items():
        bn = model.get_submodule(name)
        bn.running_mean.copy_(new["mean"])
        bn.running_var.copy_(new["var"])
    return model
