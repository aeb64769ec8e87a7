"""Plain PyTorch reference of the SelfMask MaskFormer.

The model of Shin et al., "Unsupervised Salient Object Detection with
Spectral Cluster Voting" (CVPRW 2022; github.com/NoelShin/selfmask): a
ViT-S/8 (DINO ``deit_small``) or dilated-8 ResNet-50 encoder, a DETR
post-norm decoder of 20 queries, a bilinear x2 pixel decoder, the mask
head (queries . upsampled tokens, sigmoid) and the binary objectness head
(a ReLU MLP 384 -> 384 -> 384 -> 1, sigmoid).

Everything is written out here with ``torch`` operations alone: no kernel,
no batching trick, no cache.  Parameters live in a flat dict under the
published state-dict names (``encoder.blocks.0.attn.qkv.weight``,
``decoder.layers.0.self_attn.in_proj_weight``, ...), so the benchmark hands
one set of tensors to the program and to this file.  ``param_specs`` says
which names and shapes the model has and how each is drawn.

Arithmetic is f32 with TF32 off (the caller switches it off, see
``tf32_off``).  ``Arith("fp8")`` keeps in float8 what the program keeps in
bf16 (e4m3 values, e5m2 gradients, per-tensor scales): the step below the
bf16 the configuration computes in, the control the comparison must fail.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VIT_LN_EPS = 1e-6
DECODER_LN_EPS = 1e-5
BN_EPS = 1e-5
RESNET_PLANES = (64, 128, 256, 512)
RESNET50_BLOCKS = (3, 4, 6, 3)
FP8_MAX = 448.0          # largest e4m3 value
FP8_E5M2_MAX = 57344.0   # largest e5m2 value


@contextlib.contextmanager
def tf32_off():
    """f32 products in f32 on the card (TF32 would round to 10 bits)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    scale = top / x.abs().amax().clamp_min(1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """float8 under a per-tensor scale, as fp8 training stores tensors: the
    value in e4m3, its gradient in e5m2."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, FP8_E5M2_MAX)


_fp8 = _Fp8.apply


class Arith:
    """Where the precision of the model's arithmetic is set.  In ``f32``
    every operation is f32.  In ``fp8`` what the program keeps in bf16 is
    kept in float8 instead: both operands of every product and
    convolution, and every activation the program stores in bf16 (the
    tokens, each layer's output, the attention probabilities before their
    product), e4m3 forward and their gradients e5m2 backward; what the
    program computes in f32 (attention logits and softmax, LayerNorm and
    BatchNorm statistics, the heads) stays f32."""

    def __init__(self, prec: str = "f32"):
        if prec not in ("f32", "fp8"):
            raise ValueError(prec)
        self.prec = prec

    def act(self, x):
        """An activation as the configuration's precision stores it."""
        return _fp8(x) if self.prec == "fp8" else x

    def matmul(self, a, b):
        """A product whose result stays f32 (attention logits)."""
        return torch.matmul(self.act(a), self.act(b))

    def linear(self, x, w, b=None):
        y = torch.matmul(self.act(x), self.act(w).t())
        return self.act(y if b is None else y + b)

    def conv(self, x, w, stride=1, padding=0, dilation=1):
        return self.act(F.conv2d(self.act(x), self.act(w), stride=stride, padding=padding,
                                 dilation=dilation))


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _linear_spec(name, n_in, n_out, init) -> List[Tuple]:
    if init == "trunc":            # the ViT's linears: N(0, 0.02), zero bias
        return [(f"{name}.weight", (n_out, n_in), "normal", 0.02),
                (f"{name}.bias", (n_out,), "zeros", 0.0)]
    bound = 1.0 / math.sqrt(n_in)  # torch's default Linear init
    return [(f"{name}.weight", (n_out, n_in), "uniform", bound),
            (f"{name}.bias", (n_out,), "uniform", bound)]


def _norm_spec(name, d, buffers=False) -> List[Tuple]:
    out = [(f"{name}.weight", (d,), "ones", 0.0), (f"{name}.bias", (d,), "zeros", 0.0)]
    if buffers:
        out += [(f"{name}.running_mean", (d,), "zeros", 0.0),
                (f"{name}.running_var", (d,), "ones", 0.0)]
    return out


def _conv_spec(name, cout, cin, k) -> Tuple:
    # He-normal N(0, sqrt(2 / (k k cout)))
    return (f"{name}.weight", (cout, cin, k, k), "normal", math.sqrt(2.0 / (k * k * cout)))


def vit_specs(patch: int, d: int = 384, depth: int = 12, pos_grid: int = 28) -> List[Tuple]:
    bound = 1.0 / math.sqrt(3 * patch * patch)
    out = [("encoder.patch_embed.proj.weight", (d, 3, patch, patch), "uniform", bound),
           ("encoder.patch_embed.proj.bias", (d,), "uniform", bound),
           ("encoder.cls_token", (1, 1, d), "zeros", 0.0),
           ("encoder.pos_embed", (1, pos_grid * pos_grid + 1, d), "normal", 0.02)]
    for i in range(depth):
        pre = f"encoder.blocks.{i}"
        out += _norm_spec(f"{pre}.norm1", d)
        out += _linear_spec(f"{pre}.attn.qkv", d, 3 * d, "trunc")
        out += _linear_spec(f"{pre}.attn.proj", d, d, "trunc")
        out += _norm_spec(f"{pre}.norm2", d)
        out += _linear_spec(f"{pre}.mlp.fc1", d, 4 * d, "trunc")
        out += _linear_spec(f"{pre}.mlp.fc2", 4 * d, d, "trunc")
    return out + _norm_spec("encoder.norm", d)


def resnet50_specs() -> List[Tuple]:
    out = [_conv_spec("encoder.conv1", 64, 3, 7)] + _norm_spec("encoder.bn1", 64, True)
    cin = 64
    for i, (n, planes) in enumerate(zip(RESNET50_BLOCKS, RESNET_PLANES)):
        for b in range(n):
            pre = f"encoder.layer{i + 1}.{b}"
            out.append(_conv_spec(f"{pre}.conv1", planes, cin, 1))
            out += _norm_spec(f"{pre}.bn1", planes, True)
            out.append(_conv_spec(f"{pre}.conv2", planes, planes, 3))
            out += _norm_spec(f"{pre}.bn2", planes, True)
            out.append(_conv_spec(f"{pre}.conv3", planes * 4, planes, 1))
            out += _norm_spec(f"{pre}.bn3", planes * 4, True)
            if b == 0:
                out.append(_conv_spec(f"{pre}.downsample.0", planes * 4, cin, 1))
                out += _norm_spec(f"{pre}.downsample.1", planes * 4, True)
            cin = planes * 4
    return out


def param_specs(arch: str, patch_size: int = 8, n_queries: int = 20,
                n_decoder_layers: int = 6, d: int = 384) -> List[Tuple]:
    """[(name, shape, init, scale)] of the whole model, buffers included;
    ``init`` is ``normal`` (std ``scale``, clipped at +-2), ``uniform``
    (+-``scale``), ``ones`` or ``zeros``."""
    if arch == "vit_small":
        out = vit_specs(patch_size, d, pos_grid=224 // patch_size)
    elif arch == "resnet50":
        out = resnet50_specs()
    else:
        raise ValueError(arch)
    in_bound = math.sqrt(6.0 / (d + 3 * d))      # xavier-uniform of the packed in_proj
    for i in range(n_decoder_layers):
        pre = f"decoder.layers.{i}"
        for attn in ("self_attn", "multihead_attn"):
            out += [(f"{pre}.{attn}.in_proj_weight", (3 * d, d), "uniform", in_bound),
                    (f"{pre}.{attn}.in_proj_bias", (3 * d,), "zeros", 0.0),
                    (f"{pre}.{attn}.out_proj.weight", (d, d), "uniform", 1.0 / math.sqrt(d)),
                    (f"{pre}.{attn}.out_proj.bias", (d,), "zeros", 0.0)]
        out += _linear_spec(f"{pre}.linear1", d, 4 * d, "default")
        out += _linear_spec(f"{pre}.linear2", 4 * d, d, "default")
        for n in ("norm1", "norm2", "norm3"):
            out += _norm_spec(f"{pre}.{n}", d)
    out += _norm_spec("decoder.norm", d)
    out.append(("query_embed", (n_queries, d), "normal", 1.0))
    for i, (a, b) in enumerate(((d, d), (d, d), (d, 1))):
        out += _linear_spec(f"ffn.layers.{i}", a, b, "default")
    if arch == "resnet50":
        out += _linear_spec("linear_layer", 2048, d, "default")
    return out


def is_buffer(name: str) -> bool:
    return name.endswith(("running_mean", "running_var"))


def make_weights(specs, gen: torch.Generator, device,
                 dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every tensor of ``specs`` from ``gen``: one normal and one uniform
    draw for the whole model, on ``device``."""
    n_normal = sum(math.prod(s) for _, s, init, _ in specs if init == "normal")
    n_uniform = sum(math.prod(s) for _, s, init, _ in specs if init == "uniform")
    z = torch.randn(n_normal, generator=gen, device=device)
    u = torch.rand(n_uniform, generator=gen, device=device)
    out, iz, iu = {}, 0, 0
    for name, shape, init, scale in specs:
        n = math.prod(shape)
        if init == "normal":
            t = (z[iz:iz + n] * scale).clamp_(-2.0, 2.0)
            iz += n
        elif init == "uniform":
            t = (u[iu:iu + n] * 2.0 - 1.0) * scale
            iu += n
        elif init == "ones":
            t = torch.ones(n, device=device)
        else:
            t = torch.zeros(n, device=device)
        out[name] = t.reshape(shape).to(dtype)
    return out


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> ImageNet-normalised f32."""
    mean = torch.tensor(IMAGENET_MEAN, device=u8.device)
    std = torch.tensor(IMAGENET_STD, device=u8.device)
    return (u8.float() / 255.0 - mean) / std


def layer_norm(x, w, b, eps):
    mean = x.mean(-1, keepdim=True)
    var = (x - mean).square().mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps) * w + b


def attention(ar: Arith, q, k, v, key_mask=None):
    """softmax(q k^T / sqrt(d)) v over [B, H, N, d]; False keys of
    ``key_mask`` [B, Nk] leave the softmax."""
    s = ar.matmul(q, k.transpose(-1, -2)) / math.sqrt(q.shape[-1])
    if key_mask is not None:
        s = s.masked_fill(~key_mask[:, None, None, :], float("-inf"))
    return ar.act(ar.matmul(ar.act(torch.softmax(s, dim=-1)), v))


def _heads(x, n_heads):
    b, n, d = x.shape
    return x.reshape(b, n, n_heads, d // n_heads).transpose(1, 2)


def _merge(x):
    b, h, n, hd = x.shape
    return x.transpose(1, 2).reshape(b, n, h * hd)


def pos_embed_for(P, gh: int, gw: int) -> torch.Tensor:
    """The [1, 1 + gh gw, D] positional embedding of a (gh, gw) grid: the
    learned table, bicubic-resized (half-pixel centres) where it differs."""
    pe = P["encoder.pos_embed"]
    g = int(round(math.sqrt(pe.shape[1] - 1)))
    if (gh, gw) == (g, g):
        return pe
    d = pe.shape[-1]
    grid = pe[:, 1:].reshape(1, g, g, d).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, size=(gh, gw), mode="bicubic", align_corners=False)
    return torch.cat([pe[:, :1], grid.permute(0, 2, 3, 1).reshape(1, gh * gw, d)], 1)


def vit_forward(P, ar: Arith, x, n_heads=6, depth=12, token_mask=None, pos=None):
    """x [B, H, W, 3] normalised (H, W multiples of the patch) -> the final
    LayerNorm of the last block's tokens [B, 1 + N, D] and the grid."""
    w = P["encoder.patch_embed.proj.weight"]
    p = w.shape[-1]
    t = ar.act(ar.conv(ar.act(x).permute(0, 3, 1, 2), w, stride=p)
               + P["encoder.patch_embed.proj.bias"][:, None, None])
    b, d, gh, gw = t.shape
    t = t.flatten(2).transpose(1, 2)
    t = torch.cat([P["encoder.cls_token"].expand(b, 1, d), t], 1)
    t = ar.act(t + (pos if pos is not None else pos_embed_for(P, gh, gw)))

    def norm(name, z):
        return ar.act(layer_norm(z, P[name + ".weight"], P[name + ".bias"], VIT_LN_EPS))

    for i in range(depth):
        pre = f"encoder.blocks.{i}."
        qkv = ar.linear(norm(pre + "norm1", t), P[pre + "attn.qkv.weight"], P[pre + "attn.qkv.bias"])
        q, k, v = (_heads(z, n_heads) for z in qkv.chunk(3, dim=-1))
        o = _merge(attention(ar, q, k, v, token_mask))
        t = ar.act(t + ar.linear(o, P[pre + "attn.proj.weight"], P[pre + "attn.proj.bias"]))
        h = ar.linear(norm(pre + "norm2", t), P[pre + "mlp.fc1.weight"], P[pre + "mlp.fc1.bias"])
        t = ar.act(t + ar.linear(ar.act(F.gelu(h)), P[pre + "mlp.fc2.weight"],
                                 P[pre + "mlp.fc2.bias"]))
    return norm("encoder.norm", t), (gh, gw)


def _bn(P, ar, name, x, train, stats):
    w, b = P[name + ".weight"], P[name + ".bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = x.var(dim=(0, 2, 3), unbiased=False)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    inv = w / torch.sqrt(var + BN_EPS)
    return ar.act(x * inv[:, None, None] + (b - mean * inv)[:, None, None])


def resnet50_forward(P, ar: Arith, x, train: bool, stats=None):
    """Dilated-8 ResNet-50 (v1.5 bottlenecks, layer3 unstrided at dilation 2,
    layer4 at 4): x [B, H, W, 3] -> res5 [B, H/8, W/8, 2048]."""
    def conv(name, h, stride=1, dil=1):
        w = P[name + ".weight"]
        return ar.conv(h, w, stride=stride, padding=dil * (w.shape[-1] - 1) // 2, dilation=dil)

    h = ar.act(x).permute(0, 3, 1, 2)
    h = F.relu(_bn(P, ar, "encoder.bn1", conv("encoder.conv1", h, stride=2), train, stats))
    h = F.max_pool2d(h, 3, 2, 1)
    # (first block's stride, its dilation, the others' dilation) per stage
    geometry = ((1, 1, 1), (2, 1, 1), (1, 1, 2), (1, 2, 4))
    for i, n in enumerate(RESNET50_BLOCKS):
        s0, d0, dr = geometry[i]
        for blk in range(n):
            pre = f"encoder.layer{i + 1}.{blk}."
            stride, dil = (s0, d0) if blk == 0 else (1, dr)
            o = F.relu(_bn(P, ar, pre + "bn1", conv(pre + "conv1", h), train, stats))
            o = F.relu(_bn(P, ar, pre + "bn2", conv(pre + "conv2", o, stride, dil), train, stats))
            o = _bn(P, ar, pre + "bn3", conv(pre + "conv3", o), train, stats)
            if blk == 0:
                h = _bn(P, ar, pre + "downsample.1", conv(pre + "downsample.0", h, stride),
                        train, stats)
            h = ar.act(F.relu(o + h))
    return h.permute(0, 2, 3, 1)


def _mha(P, ar: Arith, pre, q_in, k_in, v_in, n_heads, key_mask=None):
    w, b = P[pre + "in_proj_weight"], P[pre + "in_proj_bias"]
    d = q_in.shape[-1]
    q, k, v = (_heads(ar.linear(t, w[i * d:(i + 1) * d], b[i * d:(i + 1) * d]), n_heads)
               for i, t in enumerate((q_in, k_in, v_in)))
    o = _merge(attention(ar, q, k, v, key_mask))
    return ar.linear(o, P[pre + "out_proj.weight"], P[pre + "out_proj.bias"])


def decoder_forward(P, ar: Arith, memory, n_layers=6, n_heads=6, memory_mask=None):
    """DETR post-norm decoder: [B, L, Q, D], each layer through the final norm."""
    b, _, d = memory.shape
    pos = ar.act(P["query_embed"][None].expand(b, -1, -1))
    tgt = torch.zeros_like(pos)
    outs = []
    for i in range(n_layers):
        pre = f"decoder.layers.{i}."

        def norm(name, t):
            return ar.act(layer_norm(ar.act(t), P[name + ".weight"], P[name + ".bias"],
                                     DECODER_LN_EPS))

        qk = ar.act(tgt + pos)
        tgt = norm(pre + "norm1", tgt + _mha(P, ar, pre + "self_attn.", qk, qk, tgt, n_heads))
        tgt = norm(pre + "norm2", tgt + _mha(P, ar, pre + "multihead_attn.", ar.act(tgt + pos),
                                             memory, memory, n_heads, memory_mask))
        h = F.relu(ar.linear(tgt, P[pre + "linear1.weight"], P[pre + "linear1.bias"]))
        tgt = norm(pre + "norm3",
                   tgt + ar.linear(h, P[pre + "linear2.weight"], P[pre + "linear2.bias"]))
        outs.append(norm("decoder.norm", tgt))
    return torch.stack(outs, 1)


def heads(P, queries, upsampled):
    """mask_pred [B, L, Q, h, w], objectness [B, L, Q] (both sigmoid) and
    the contrastive features [B, D] (the last layer's mean query)."""
    mask = torch.sigmoid(torch.einsum("blqd,bhwd->blqhw", queries, upsampled))
    h = queries
    for i in range(3):
        h = torch.matmul(h, P[f"ffn.layers.{i}.weight"].t()) + P[f"ffn.layers.{i}.bias"]
        if i < 2:
            h = F.relu(h)
    return {"mask_pred": mask, "objectness": torch.sigmoid(h[..., 0]),
            "features": queries[:, -1].mean(1)}


def upsample_tokens(tokens, grid, scale: int = 2):
    b, _, d = tokens.shape
    gh, gw = grid
    f = tokens.reshape(b, gh, gw, d).permute(0, 3, 1, 2)
    f = F.interpolate(f, size=(gh * scale, gw * scale), mode="bilinear", align_corners=False)
    return f.permute(0, 2, 3, 1)


def forward(P, u8: torch.Tensor, arch: str, ar: Arith = None, train: bool = False,
            stats=None) -> Dict[str, torch.Tensor]:
    """The whole model on uint8 images [B, H, W, 3] (H, W multiples of 8)."""
    ar = ar or Arith()
    x = normalize(u8)
    if arch == "vit_small":
        tokens, grid = vit_forward(P, ar, x)
        memory = tokens[:, 1:]
    else:
        feats = resnet50_forward(P, ar, x, train, stats)
        feats = ar.linear(feats, P["linear_layer.weight"], P["linear_layer.bias"])
        b, gh, gw, d = feats.shape
        memory, grid = feats.reshape(b, gh * gw, d), (gh, gw)
    queries = decoder_forward(P, ar, memory)
    return heads(P, queries, ar.act(upsample_tokens(memory, grid)))
