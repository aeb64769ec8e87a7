"""Operation and byte counts of SelfMask nq20 on DINOv2's ViT-g/14 with
registers, from its shapes, as ``flops.py`` counts the ViT-S model: a
product of (m, k) by (k, n) is 2 m k n operations, elementwise work is left
out, a training image counts its forward three times.

Besides the model's count (``mfu.train``), the step's linear products on
the tensor cores (``ops/layers.py`` ``linear`` through ``linear_tc``: the
forward, dx where the input needs a gradient, dW) and their least time at
the card's peaks (``gemm_roofline.train``).
"""
from __future__ import annotations

from typing import List, Tuple

from sodbench import flops

D, DEPTH, HEADS, PATCH, REGISTERS = 1536, 40, 24, 14, 4
HIDDEN = (int(4 * D * 2 / 3) + 7) // 8 * 8          # SwiGLU's 4096
D_DECODER = 384


def grid(image_hw: Tuple[int, int]) -> Tuple[int, int]:
    return image_hw[0] // PATCH, image_hw[1] // PATCH


def tokens(image_hw: Tuple[int, int]) -> int:
    """CLS, the registers and the patches: 1374 at 518 px."""
    gh, gw = grid(image_hw)
    return 1 + REGISTERS + gh * gw


def encoder_flops(image_hw: Tuple[int, int]) -> int:
    """The patch embedding, then per block qkv, q k^T, p v, proj, w12, w3."""
    gh, gw = grid(image_hw)
    n = tokens(image_hw)
    embed = 2 * gh * gw * 3 * PATCH * PATCH * D
    block = 2 * n * D * (3 * D + D + 2 * HIDDEN) + 2 * n * HIDDEN * D + 4 * n * n * D
    return embed + DEPTH * block


def forward_flops(image_hw: Tuple[int, int]) -> int:
    """One image's forward: the encoder, the adapter on the patch tokens,
    the decoder and the heads at the x2 pixel grid."""
    gh, gw = grid(image_hw)
    p = gh * gw
    return (encoder_flops(image_hw) + 2 * p * D * D_DECODER + flops.decoder_flops(p)
            + flops.heads_flops(4 * p))


def train_flops(image_hw: Tuple[int, int]) -> int:
    return 3 * forward_flops(image_hw)


def linear_shapes(batch: int, image_hw: Tuple[int, int], n_queries: int = 20,
                  layers: int = 6) -> List[Tuple[int, int, int, bool]]:
    """(rows m, out n, in k, whether dx is computed) of every bf16 linear a
    training step runs on the tensor cores (``remat`` off): per block qkv,
    proj, w12 and w3 over the batch's tokens; the adapter over the patch
    tokens; per decoder layer the query, key, value and output projections
    of both attentions and the FFN.
    The first layer's self-attention value is the zero target, whose
    projection has no dx.  The patch embedding (k 588) stays on the f32
    products and the objectness MLP is f32: neither is here."""
    gh, gw = grid(image_hw)
    m, p, q = batch * tokens(image_hw), batch * gh * gw, batch * n_queries
    d = D_DECODER
    out = [(m, 3 * D, D, True), (m, D, D, True), (m, 2 * HIDDEN, D, True),
           (m, D, HIDDEN, True)] * DEPTH
    out.append((p, d, D, True))
    for i in range(layers):
        out += [(q, d, d, True), (q, d, d, True), (q, d, d, i > 0), (q, d, d, True)]
        out += [(q, d, d, True), (p, d, d, True), (p, d, d, True), (q, d, d, True)]
        out += [(q, 4 * d, d, True), (q, d, 4 * d, True)]
    return out


def linear_products(m: int, n: int, k: int, dx: bool) -> List[Tuple[int, int]]:
    """(operations, bytes) of each product of one ``linear_tc`` call: the
    forward (x, the bf16 W and the f32 bias read, y written), dx (dy and W
    read, dx written) and dW (dy and x read, the f32 dW written)."""
    ops = 2 * m * n * k
    out = [(ops, 2 * m * k + 2 * n * k + 4 * n + 2 * m * n)]
    if dx:
        out.append((ops, 2 * m * n + 2 * n * k + 2 * m * k))
    out.append((ops, 2 * m * n + 2 * m * k + 4 * n * k))
    return out


def linear_bound_s(batch: int, image_hw: Tuple[int, int]) -> float:
    """The least time of one step's linear products: each product's bound
    (``flops.bound_s``), summed."""
    return sum(flops.bound_s(*prod) for m, n, k, dx in linear_shapes(batch, image_hw)
               for prod in linear_products(m, n, k, dx))
