"""Operation and byte counts of the model and of the port's kernels,
from their shapes, and the card's peaks they are held against.

A matrix product of (m, k) by (k, n) counts 2 m k n operations.  The
model's counts are the work one image needs: every product of the
encoder, the decoder and the heads (elementwise work is left out); a
training image counts its forward three times (forward, and the two
products of each backward).  A kernel's bytes are its inputs read once
and its outputs written once.
"""
from __future__ import annotations

import json
import os
from typing import Iterable, Tuple

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "peaks.json")


def peaks() -> dict:
    with open(_PEAKS) as f:
        return json.load(f)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the two bounds."""
    p = peaks()
    return max(flops / p["bf16_flops_per_s"], nbytes / p["hbm_bytes_per_s"])


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

def vit_flops(n_tokens: int, patch: int = 8, d: int = 384, depth: int = 12,
              mlp_ratio: int = 4) -> int:
    """ViT-S encoder over ``n_tokens`` (CLS included): the patch embedding,
    then per block qkv, q k^T, p v, proj, fc1, fc2."""
    n = n_tokens
    embed = 2 * (n - 1) * 3 * patch * patch * d
    block = 2 * n * d * (3 * d + d + 2 * mlp_ratio * d) + 4 * n * n * d
    return embed + depth * block


def resnet50_d8_flops(h: int, w: int) -> int:
    """Dilated-8 ResNet-50 convolutions (dilation keeps layer3 and layer4
    at 1/8 of the input)."""
    def conv(cout, cin, k, ho, wo):
        return 2 * cout * cin * k * k * ho * wo

    ho, wo = -(-h // 2), -(-w // 2)                    # the 7x7/2 stem
    total = conv(64, 3, 7, ho, wo)
    ho, wo = -(-ho // 2), -(-wo // 2)                  # the 3x3/2 max pool
    cin = 64
    for stage, (blocks, planes) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        stride = 2 if stage == 1 else 1
        for b in range(blocks):
            s = stride if b == 0 else 1
            total += conv(planes, cin, 1, ho, wo)
            ho2, wo2 = -(-ho // s), -(-wo // s)
            total += conv(planes, planes, 3, ho2, wo2)
            total += conv(planes * 4, planes, 1, ho2, wo2)
            if b == 0:
                total += conv(planes * 4, cin, 1, ho2, wo2)
            ho, wo, cin = ho2, wo2, planes * 4
    return total


def decoder_flops(n_memory: int, n_queries: int = 20, d: int = 384, layers: int = 6) -> int:
    """DETR decoder: self-attention over the queries, cross-attention to
    ``n_memory`` tokens, the FFN."""
    q, n = n_queries, n_memory
    self_attn = 2 * q * d * 3 * d + 4 * q * q * d + 2 * q * d * d
    cross = 2 * q * d * d + 2 * n * d * 2 * d + 4 * q * n * d + 2 * q * d * d
    ffn = 2 * 2 * q * d * 4 * d
    return layers * (self_attn + cross + ffn)


def heads_flops(mask_hw: int, n_queries: int = 20, d: int = 384, layers: int = 6) -> int:
    """The masks (queries . upsampled tokens) and the objectness MLP of
    ``layers`` decoder layers."""
    return layers * n_queries * (2 * mask_hw * d + 2 * (2 * d * d + d))


def forward_flops(arch: str, image_hw: Tuple[int, int], patch: int = 8, layers: int = 6,
                  head_layers: int = 6) -> int:
    """One image's forward at ``image_hw``."""
    h, w = image_hw
    if arch == "vit_small":
        gh, gw = h // patch, w // patch
        enc = vit_flops(gh * gw + 1, patch)
    else:
        gh, gw = -(-h // 8), -(-w // 8)
        enc = resnet50_d8_flops(h, w) + 2 * gh * gw * 2048 * 384   # + linear_layer
    return (enc + decoder_flops(gh * gw, layers=layers)
            + heads_flops(4 * gh * gw, layers=head_layers))


def train_flops(arch: str, image_hw: Tuple[int, int]) -> int:
    return 3 * forward_flops(arch, image_hw)


def canvas_flops(real_tokens: Iterable[int], patch: int = 8) -> int:
    """Evaluation of a canvas batch on each image's real tokens (CLS
    included): encoder, decoder, and the last layer's heads."""
    total = 0
    for n in real_tokens:
        total += vit_flops(n, patch) + decoder_flops(n - 1) + heads_flops(4 * (n - 1), layers=1)
    return total


# ---------------------------------------------------------------------------
# The port's kernels
# ---------------------------------------------------------------------------

def k2_forward(b: int, h: int, n: int, hd: int) -> Tuple[int, int]:
    """(operations, bytes) of one flash attention forward over [b, h, n, hd]
    bf16: q k^T and p v; q, k, v read, o written."""
    return 4 * b * h * n * n * hd, 4 * b * h * n * hd * 2


def k2_backward(b: int, h: int, n: int, hd: int) -> Tuple[int, int]:
    """The backward's four products (dv, dp, dq, dk); q, k, v, o, do and
    the f32 row statistics read, dq, dk, dv written."""
    return 8 * b * h * n * n * hd, 8 * b * h * n * hd * 2 + 2 * b * h * n * 4


def k2_forward_masked(tokens: Iterable[int], h: int, hd: int) -> Tuple[int, int]:
    """A masked forward over a canvas batch, on each image's real tokens."""
    tokens = list(tokens)
    return (sum(4 * h * n * n * hd for n in tokens), sum(4 * h * n * hd * 2 for n in tokens))


def k1_block(b: int, n: int, d: int = 384, mlp_ratio: int = 4) -> Tuple[int, int]:
    """One fused ViT block over b images of n real tokens: its four
    products and attention; the bf16 weights and the tokens read, the
    tokens written."""
    ops = 2 * b * n * d * (3 * d + d + 2 * mlp_ratio * d) + 4 * b * n * n * d
    weights = (3 * d * d + d * d + 2 * mlp_ratio * d * d) * 2 + (3 * d + 3 * d + mlp_ratio * d) * 4
    return ops, weights + 2 * b * n * d * 2
