"""MaskFormer saliency model of the port (twin of
``sod_tpu/models/maskformer.py``): a ViT-S encoder (or a dilated-8
ResNet-50 with a linear adapter over its res5 channels), the DETR
post-norm decoder, the bilinear pixel decoder, and the binary objectness
head (or, with ``use_binary_classifier=False``, the mask-embedding MLP).

Parameter names are the reference's ``selfmask_nq20.pt`` keys
(``encoder.*``, ``decoder.layers.{i}.*``, ``decoder.norm.*``,
``query_embed``, ``ffn.layers.{i}.*``; ``linear_classifier.*`` and
``norm.*`` of the non-bc head; ``linear_layer.*`` of the ResNet adapter,
the ResNet under torchvision's names).  Layouts: images NHWC, queries
[B, L, Q, D], ``mask_pred`` [B, L, Q, h, w].

Also here, as in ``sod_tpu``, the learnable pixel decoder's pieces that no
forward calls (``positional_encoding_2d``, ``upsample_block_*``,
``position_embedding_sine``): ``learnable_pixel_decoder`` is accepted and
the pixel decoder stays bilinear whatever it says.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sod_tpu_torch.models.resnet import (RESNET50_OUT_CHANNELS, ResNet, resnet50_apply,
                                         resnet_state_init)
from sod_tpu_torch.models.vit import ViTConfig, VisionTransformer, vit_apply, vit_init, vit_small
from sod_tpu_torch.ops.attention import MultiheadAttention, mha_init
from sod_tpu_torch.ops.layers import (LayerNorm, Linear, layer_norm_init, linear_init, mlp_apply,
                                      mlp_init)
from sod_tpu_torch.ops.resize import interpolate_bilinear

DECODER_LN_EPS = 1e-5                   # torch nn.LayerNorm's default


@dataclass(frozen=True)
class MaskFormerConfig:
    n_queries: int = 20
    n_decoder_layers: int = 6
    scale_factor: int = 2
    arch: str = "vit_small"               # "vit_small" | "resnet50"
    use_binary_classifier: bool = True
    learnable_pixel_decoder: bool = False  # read by no forward, as in sod_tpu
    lateral_connection: bool = False       # read by no forward, as in sod_tpu
    return_intermediate: bool = True       # loss_every_decoder_layer; read by
                                           # no forward, as in sod_tpu
    vit: ViTConfig = field(default_factory=vit_small)

    @property
    def embed_dim(self) -> int:
        return 384 if self.arch != "vit_small" else self.vit.embed_dim

    @property
    def n_heads(self) -> int:
        return 6 if self.arch != "vit_small" else self.vit.n_heads


def config_from(cfg) -> MaskFormerConfig:
    """MaskFormerConfig from the flat experiment ``Config`` (any object
    with its fields).  ``fsdp``, ``pp_microbatches`` and the mesh axes
    (``mesh_data_axis``, ``mesh_model_axis``, ``mesh_pipe_axis``,
    ``mesh_seq_axis``) are read by the Trainer (``parallel/``), as in
    ``sod_tpu``.
    ``arch``, ``use_binary_classifier``, ``learnable_pixel_decoder``,
    ``lateral_connection`` and ``loss_every_decoder_layer`` (as
    ``return_intermediate``) are carried as ``sod_tpu`` carries them;
    ``remat`` checkpoints each encoder block in the backward;
    ``use_pallas_attention`` routes the encoder's self-attention through the
    K2 kernels, ``use_fused_mlp`` the blocks' MLP half through K4,
    ``use_fused_train`` the training blocks through K3 then K4,
    ``fused_save_acts`` picks their saved-activation variants
    (``sod_tpu/models/maskformer.py:94-98``); ``use_fused_eval`` is read by
    the Evaluator, ``quantize`` by the inference service,
    ``grad_accum_mode`` by the train step, ``async_checkpoint`` by the
    Trainer and ``use_copy_paste`` by the dataset (as in ``sod_tpu``), not
    by the model."""
    return MaskFormerConfig(
        n_queries=cfg.n_queries, n_decoder_layers=cfg.n_decoder_layers,
        scale_factor=cfg.scale_factor,
        arch=getattr(cfg, "arch", "vit_small"),
        use_binary_classifier=getattr(cfg, "use_binary_classifier", True),
        learnable_pixel_decoder=getattr(cfg, "learnable_pixel_decoder", False),
        lateral_connection=getattr(cfg, "lateral_connection", False),
        return_intermediate=getattr(cfg, "loss_every_decoder_layer", True),
        vit=vit_small(patch_size=cfg.patch_size,
                      use_flash=getattr(cfg, "use_pallas_attention", True),
                      remat=getattr(cfg, "remat", False),
                      fused_mlp=getattr(cfg, "use_fused_mlp", False),
                      fused_train=getattr(cfg, "use_fused_train", False),
                      fused_save_acts=getattr(cfg, "fused_save_acts", False)))


class DecoderLayer(nn.Module):
    """DETR post-norm layer: self-attn -> cross-attn -> FFN, each followed
    by residual + LayerNorm (dropout is 0 in the live config)."""

    def __init__(self, d: int, n_heads: int):
        super().__init__()
        self.self_attn = MultiheadAttention(d, n_heads)
        self.multihead_attn = MultiheadAttention(d, n_heads)
        self.linear1 = Linear(d, 4 * d)
        self.linear2 = Linear(4 * d, d)
        self.norm1 = LayerNorm(d, DECODER_LN_EPS)
        self.norm2 = LayerNorm(d, DECODER_LN_EPS)
        self.norm3 = LayerNorm(d, DECODER_LN_EPS)

    def forward(self, tgt, memory, query_pos, memory_mask=None):
        """:param memory_mask: [B, N] bool, False memory tokens (canvas
        padding) excluded from the cross-attention."""
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.self_attn(qk, qk, tgt))
        tgt = self.norm2(tgt + self.multihead_attn(tgt + query_pos, memory,
                                                   memory, memory_mask))
        return self.norm3(tgt + self.linear2(torch.relu(self.linear1(tgt))))


class TransformerDecoder(nn.Module):
    def __init__(self, cfg: MaskFormerConfig):
        super().__init__()
        d = cfg.embed_dim
        self.layers = nn.ModuleList(
            DecoderLayer(d, cfg.n_heads) for _ in range(cfg.n_decoder_layers))
        self.norm = LayerNorm(d, DECODER_LN_EPS)


class MLP(nn.Module):
    """DETR relu MLP (``ffn.layers.{i}``)."""

    def __init__(self, dims):
        super().__init__()
        self.layers = nn.ModuleList(Linear(a, b)
                                    for a, b in zip(dims[:-1], dims[1:]))


def forward_transformer_decoder(model: "MaskFormer", memory: torch.Tensor,
                                memory_mask: Optional[torch.Tensor] = None,
                                layer_apply: Optional[Callable] = None
                                ) -> torch.Tensor:
    """Queries through every decoder layer: [B, L, Q, D], each layer's
    output passed through the decoder's final LayerNorm.

    :param layer_apply: optional ``(layer, tgt, memory, query_pos,
        memory_mask) -> tgt`` run in place of each layer's forward (the
        tensor-parallel layer, ``parallel/tp.py``)."""
    b, _, d = memory.shape
    # the patch tokens are a slice of the encoder's tokens; one copy here
    # makes every layer's K and V rows contiguous (ops/layers.py linear)
    memory = memory.contiguous()
    query_pos = model.query_embed.to(memory.dtype).expand(b, -1, d)
    tgt = torch.zeros_like(query_pos)
    per_layer = []
    for layer in model.decoder.layers:
        tgt = (layer(tgt, memory, query_pos, memory_mask) if layer_apply is None
               else layer_apply(layer, tgt, memory, query_pos, memory_mask))
        per_layer.append(model.decoder.norm(tgt))
    return torch.stack(per_layer, dim=1)


def forward_pixel_decoder(patch_tokens: torch.Tensor, grid_hw,
                          scale_factor: int) -> torch.Tensor:
    """Bilinear x``scale_factor`` upsample: [B, N, D] -> [B, H, W, D]."""
    b, _, d = patch_tokens.shape
    h, w = grid_hw
    feats = patch_tokens.reshape(b, h, w, d).permute(0, 3, 1, 2)
    feats = interpolate_bilinear(feats, h * scale_factor, w * scale_factor)
    return feats.permute(0, 2, 3, 1)


class MaskFormer(nn.Module):
    def __init__(self, cfg: MaskFormerConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.embed_dim
        if cfg.arch == "vit_small":
            self.encoder = VisionTransformer(cfg.vit)
        elif cfg.arch == "resnet50":
            self.encoder = ResNet("resnet50", seed=None)
        else:
            raise ValueError(f"unknown arch {cfg.arch!r}")
        self.decoder = TransformerDecoder(cfg)
        self.query_embed = nn.Parameter(torch.empty(cfg.n_queries, d))
        if cfg.use_binary_classifier:
            self.ffn = MLP([d, d, d, 1])
        else:
            # linear_classifier and norm are created and never read by the
            # forward, as in sod_tpu
            self.ffn = MLP([d, d, d, d])
            self.linear_classifier = Linear(d, 2)
            self.norm = LayerNorm(d, DECODER_LN_EPS)
        if cfg.arch != "vit_small":
            # the 1x1 channel adapter over res5, a linear on the channel axis
            self.linear_layer = Linear(RESNET50_OUT_CHANNELS, d)

    def forward(self, x: torch.Tensor, fused: bool = False,
                encoder_apply: Optional[Callable] = None,
                train: bool = False,
                encoder_only: bool = False,
                layer_apply: Optional[Callable] = None) -> Dict[str, torch.Tensor]:
        """:param x: [B, H, W, 3] normalized images.
        :param fused: run the ViT encoder's blocks through the fused kernel
            (the ResNet ignores it, as in ``sod_tpu``).
        :param encoder_apply: optional ``(encoder, x) -> [B, 1+N, D]``
            normed last-layer tokens used in place of the ViT encoder; must
            be the same math as ``vit_apply`` (the model-sharding layouts'
            encoders, ``parallel/``).
        :param layer_apply: see ``forward_transformer_decoder``.
        :param train: the ResNet's BatchNorm on the batch's statistics; the
            output then carries ``batch_stats``, ``{bn path: {"mean",
            "var"}}`` for ``resnet.merge_bn_stats`` (no-op for the ViT).
        :return: ``mask_pred`` [B, L, Q, h, w] (sigmoid, f32),
            ``objectness`` [B, L, Q, 1] (sigmoid, f32; binary-classifier
            head only), ``features`` [B, D].  With ``encoder_only``:
            ``patch_tokens`` [B, gh, gw, D] (``sod_tpu``'s)."""
        stats: Dict = {}
        if self.cfg.arch == "vit_small":
            p = self.cfg.vit.patch_size
            grid = (-(-x.shape[1] // p), -(-x.shape[2] // p))
            if encoder_apply is not None:
                tokens = encoder_apply(self.encoder, x)
            else:
                tokens = vit_apply(self.encoder, x, fused=fused)
            memory = tokens[:, 1:]
        else:
            feats = resnet50_apply(self.encoder, x, train=train, stats=stats)["res5"]
            feats = self.linear_layer(feats)                           # [B, h, w, D]
            b, h, w, d = feats.shape
            memory, grid = feats.reshape(b, h * w, d), (h, w)
        if encoder_only:
            return {"patch_tokens": memory.reshape(memory.shape[0], *grid, -1)}

        queries = forward_transformer_decoder(self, memory, layer_apply=layer_apply)
        upsampled = forward_pixel_decoder(memory, grid, self.cfg.scale_factor)
        out = _heads(self, queries, upsampled)
        if train and stats:
            out["batch_stats"] = stats
        return out


def _heads(model: MaskFormer, queries: torch.Tensor, upsampled: torch.Tensor,
           canvas: bool = False) -> Dict[str, torch.Tensor]:
    """Mask head, objectness head and the contrastive features.  The non-bc
    head contracts ``ffn(queries)`` (in the compute dtype) with the
    features and has no objectness; on the canvas it contracts the queries
    themselves, as ``sod_tpu``'s canvas forward does."""
    bc = model.cfg.use_binary_classifier
    emb = queries if bc or canvas else mlp_apply(model.ffn.layers, queries,
                                                 activation="relu")
    # f32 operands: a bf16 einsum would round its logits to bf16
    mask_logits = torch.einsum("blqd,bhwd->blqhw", emb.float(), upsampled.float())
    out = {"mask_pred": torch.sigmoid(mask_logits)}
    if bc:
        out["objectness"] = torch.sigmoid(
            mlp_apply(model.ffn.layers, queries.float(), activation="relu"))
    out["features"] = queries[:, -1].mean(dim=1)
    return out


def _replicate_edges(feats: torch.Tensor, gh: torch.Tensor,
                     gw: torch.Tensor) -> torch.Tensor:
    """Rows >= gh repeat row gh-1 and columns >= gw repeat column gw-1 of
    each image's [G_h, G_w, D] grid (``feats`` [B, G_h, G_w, D]), so the
    bilinear upsample of the canvas grid equals the edge-clamped upsample
    of the true (gh, gw) grid inside the valid region."""
    b, g_h, g_w, _ = feats.shape
    rows = torch.minimum(torch.arange(g_h, device=feats.device), gh[:, None] - 1)
    cols = torch.minimum(torch.arange(g_w, device=feats.device), gw[:, None] - 1)
    idx = torch.arange(b, device=feats.device)[:, None, None]
    return feats[idx, rows[:, :, None], cols[:, None, :]]


def maskformer_apply_canvas(model: MaskFormer, x: torch.Tensor,
                            token_mask: torch.Tensor,
                            pos_embed_override: torch.Tensor,
                            grid_sizes: torch.Tensor, fused: bool = False,
                            scale_factor: Optional[int] = None,
                            last_layer_only: bool = False,
                            encoder_apply: Optional[Callable] = None,
                            layer_apply: Optional[Callable] = None
                            ) -> Dict[str, torch.Tensor]:
    """Fixed-canvas forward of variable-size images (twin of
    ``sod_tpu``'s ``maskformer_apply_canvas``): each image sits top-left
    in the canvas ``x`` [B, H, W, 3]; canvas-padding tokens leave the
    encoder's attention (``token_mask`` [B, 1+N], CLS True) and the
    decoder's cross-attention; ``pos_embed_override`` [B, 1+N, D] holds
    each image's own positional embeddings; the valid grid's edge rows and
    columns are replicated over the padding before the pixel decoder's
    upsample.  The result equals the forward of each image at its own size
    inside its valid region.

    :param grid_sizes: [B, 2] integer (gh, gw) per image.
    :param scale_factor: the pixel decoder's upsample factor (default the
        model's own; a parameter-free resize, so evaluation may change it).
    :param last_layer_only: run the heads on the last decoder layer only
        (L = 1), the one evaluation reads.
    :param encoder_apply: optional ``(encoder, x, token_mask=,
        pos_embed_override=) -> [B, 1+N, D]`` in place of ``vit_apply`` (the
        model-sharding layouts' encoders, ``parallel/``).
    :param layer_apply: see ``forward_transformer_decoder``.
    :return: ``mask_pred`` [B, L, Q, s*G_h, s*G_w] over the whole canvas,
        ``objectness`` [B, L, Q, 1] (binary-classifier head only),
        ``features`` [B, D].
    """
    require_vit_canvas(model.cfg)
    if encoder_apply is None:
        tokens = vit_apply(model.encoder, x, fused=fused, token_mask=token_mask,
                           pos_embed_override=pos_embed_override)
    else:
        tokens = encoder_apply(model.encoder, x, token_mask=token_mask,
                               pos_embed_override=pos_embed_override)
    memory = tokens[:, 1:]
    queries = forward_transformer_decoder(model, memory, memory_mask=token_mask[:, 1:],
                                          layer_apply=layer_apply)
    b, n, d = memory.shape
    p = model.cfg.vit.patch_size
    gh_c, gw_c = x.shape[1] // p, x.shape[2] // p
    grid = _replicate_edges(memory.reshape(b, gh_c, gw_c, d),
                            grid_sizes[:, 0], grid_sizes[:, 1])
    upsampled = forward_pixel_decoder(grid.reshape(b, n, d), (gh_c, gw_c),
                                      scale_factor or model.cfg.scale_factor)
    if last_layer_only:
        queries = queries[:, -1:]
    return _heads(model, queries, upsampled, canvas=True)


def require_vit_canvas(cfg: MaskFormerConfig) -> None:
    """The canvas forward runs the ViT encoder only (``sod_tpu`` asserts it,
    ``maskformer.py:372``)."""
    if cfg.arch != "vit_small":
        raise ValueError("canvas path is for the ViT encoder")


def random_state_dict(model: MaskFormer, seed: int) -> Dict[str, torch.Tensor]:
    """Seeded f32 weights drawn from ``sod_tpu``'s init distributions
    (``maskformer_init``), with numpy: ViT linears and pos-embed N(0, 0.02)
    clipped at +-2, LayerNorms ones and zeros, CLS zeros, the patch conv and
    the decoder / head linears torch-default U(+-1/sqrt(fan_in)), in_proj
    xavier-uniform, out_proj U(+-1/sqrt(d)), queries N(0, 1); a ResNet
    encoder's convolutions He-normal N(0, sqrt(2 / (k * k * cout))) and its
    BatchNorms at the identity.  The ViT live config's draws are the same as
    before the ResNet and non-bc keys existed."""
    rng = np.random.default_rng(seed)
    sd = model.state_dict()
    resnet = isinstance(model.encoder, ResNet)
    out = {}
    for name, p in sd.items():
        shape = tuple(p.shape)
        parts = name.split(".")
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else None
        if resnet and parts[0] == "encoder":
            if len(shape) == 4:
                a = rng.standard_normal(shape) * math.sqrt(
                    2.0 / (shape[2] * shape[3] * shape[0]))
            elif parts[-1] in ("weight", "running_var"):
                a = np.ones(shape)
            else:
                a = np.zeros(shape)
        elif name == "query_embed":
            a = rng.standard_normal(shape)
        elif parts[-2].startswith("norm"):
            a = np.ones(shape) if parts[-1] == "weight" else np.zeros(shape)
        elif name == "encoder.cls_token":
            a = np.zeros(shape)
        elif name == "encoder.pos_embed" or (parts[1] == "blocks"
                                             and parts[-1] == "weight"):
            a = np.clip(rng.normal(0.0, 0.02, shape), -2.0, 2.0)
        elif parts[1] == "blocks" or parts[-1] == "in_proj_bias" or (
                parts[-2] == "out_proj" and parts[-1] == "bias"):
            a = np.zeros(shape)
        elif parts[-1] == "in_proj_weight":
            bound = math.sqrt(6.0 / (shape[1] + shape[0]))
            a = rng.uniform(-bound, bound, shape)
        elif parts[-2] == "out_proj":
            a = rng.uniform(-1 / math.sqrt(shape[1]), 1 / math.sqrt(shape[1]),
                            shape)
        else:                           # patch conv, decoder linears, ffn
            if fan_in is None:          # a bias: fan-in of its weight
                fan_in = int(np.prod(sd[name[:-len("bias")] + "weight"]
                                     .shape[1:]))
            bound = 1 / math.sqrt(fan_in)
            a = rng.uniform(-bound, bound, shape)
        out[name] = torch.from_numpy(np.asarray(a, np.float32))
    return out


def maskformer_init(gen: torch.Generator, cfg: MaskFormerConfig) -> Dict[str, torch.Tensor]:
    """A ``MaskFormer(cfg)`` state dict (f32, on the CPU) with
    ``sod_tpu``'s ``maskformer_init`` distributions for either arch and
    either head, drawn from ``gen``: the encoder by ``vit_init`` or
    ``resnet_state_init``, each decoder layer's attentions by ``mha_init``
    and its linears torch-default, LayerNorms ones and zeros, the queries
    N(0, 1), ``ffn``, ``linear_classifier`` and ``linear_layer``
    torch-default.  The same generator state gives the same tensors."""
    d = cfg.embed_dim
    model = MaskFormer(cfg)
    if cfg.arch == "vit_small":
        enc = vit_init(gen, cfg.vit)
    else:
        enc = resnet_state_init(model.encoder, gen)
    out = {f"encoder.{k}": v for k, v in enc.items()}

    def put(prefix: str, tensors: Dict[str, torch.Tensor]) -> None:
        out.update({f"{prefix}.{k}": v for k, v in tensors.items()})

    for i in range(cfg.n_decoder_layers):
        pre = f"decoder.layers.{i}"
        put(f"{pre}.self_attn", mha_init(gen, d))
        put(f"{pre}.multihead_attn", mha_init(gen, d))
        put(f"{pre}.linear1", linear_init(gen, d, 4 * d, init="torch_default"))
        put(f"{pre}.linear2", linear_init(gen, 4 * d, d, init="torch_default"))
        for n in ("norm1", "norm2", "norm3"):
            put(f"{pre}.{n}", layer_norm_init(d))
    put("decoder.norm", layer_norm_init(d))
    out["query_embed"] = torch.randn(cfg.n_queries, d, generator=gen)
    dims = [d, d, d, 1] if cfg.use_binary_classifier else [d, d, d, d]
    for i, lin in enumerate(mlp_init(gen, dims, init="torch_default")):
        put(f"ffn.layers.{i}", lin)
    if not cfg.use_binary_classifier:
        put("linear_classifier", linear_init(gen, d, 2, init="torch_default"))
        put("norm", layer_norm_init(d))
    if cfg.arch != "vit_small":
        put("linear_layer", linear_init(gen, RESNET50_OUT_CHANNELS, d, init="torch_default"))
    # the model's key order, so that a state dict compares key by key
    return {k: out[k] for k in model.state_dict()}


# ---------------------------------------------------------------------------
# The learnable pixel decoder's pieces: no forward calls them (as in sod_tpu)
# ---------------------------------------------------------------------------

def positional_encoding_2d(n_dims: int, height: int, width: int) -> torch.Tensor:
    """Static sin / cos 2-D positional grid [n_dims, height, width]: the
    first half of the channels encodes the column (sin on even, cos on odd
    channels), the second half the row."""
    if n_dims % 4 != 0:
        raise ValueError(f"n_dims must be divisible by 4, got {n_dims}")
    d_model = n_dims // 2
    div_term = torch.exp(torch.arange(0.0, d_model, 2.0)
                         * -(math.log(10000.0) / d_model))
    pos_w = torch.arange(0.0, width)[:, None]
    pos_h = torch.arange(0.0, height)[:, None]
    pe = torch.zeros(n_dims, height, width)
    pe[0:d_model:2] = torch.sin(pos_w * div_term).t()[:, None, :].expand(-1, height, width)
    pe[1:d_model:2] = torch.cos(pos_w * div_term).t()[:, None, :].expand(-1, height, width)
    pe[d_model::2] = torch.sin(pos_h * div_term).t()[:, :, None].expand(-1, height, width)
    pe[d_model + 1::2] = torch.cos(pos_h * div_term).t()[:, :, None].expand(-1, height, width)
    return pe


def upsample_block_init(gen: torch.Generator, in_channels: int, out_channels: int,
                        n_groups: int = 32) -> Dict:
    """The learnable pixel decoder's block (3x3 conv, GroupNorm, ReLU,
    bilinear x2): the conv (out, in, 3, 3) and its bias torch-default
    U(+-1/sqrt(9 in)), GroupNorm scale ones and bias zeros."""
    bound = 1.0 / math.sqrt(in_channels * 9)
    return {"conv": (torch.rand(out_channels, in_channels, 3, 3, generator=gen) * 2 - 1) * bound,
            "conv_b": (torch.rand(out_channels, generator=gen) * 2 - 1) * bound,
            "gn_scale": torch.ones(out_channels), "gn_bias": torch.zeros(out_channels),
            "n_groups": n_groups}


def upsample_block_apply(p: Dict, x: torch.Tensor, scale_factor: int = 2) -> torch.Tensor:
    """x [B, H, W, C] -> [B, H*s, W*s, C']: the conv on f32 copies of
    ``x.dtype`` operands (as ``sod_tpu``'s f32-accumulated conv, not
    rounded before the bias), GroupNorm (eps 1e-5) and ReLU in f32, one
    cast back to ``x.dtype``, then the bilinear upsample.  On the card the
    f32 conv runs in TF32 unless ``torch.backends.cudnn.allow_tf32`` is
    off."""
    y = F.conv2d(x.permute(0, 3, 1, 2).float(), p["conv"].to(x.dtype).float(), padding=1)
    y = y + p["conv_b"].float()[:, None, None]
    b, c, h, w = y.shape
    g = int(p["n_groups"])
    yg = y.reshape(b, g, c // g, h, w)
    mean = yg.mean(dim=(2, 3, 4), keepdim=True)
    var = (yg - mean).square().mean(dim=(2, 3, 4), keepdim=True)
    yg = (yg - mean) * torch.rsqrt(var + 1e-5)
    y = yg.reshape(b, c, h, w) * p["gn_scale"].float()[:, None, None] \
        + p["gn_bias"].float()[:, None, None]
    y = torch.relu(y).to(x.dtype)
    y = interpolate_bilinear(y, h * scale_factor, w * scale_factor)
    return y.permute(0, 2, 3, 1)


def position_embedding_sine(mask_shape, num_pos_feats: int = 64,
                            temperature: float = 10000.0, normalize: bool = False,
                            scale: Optional[float] = None,
                            not_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """DETR's sine position embedding [B, 2 * num_pos_feats, H, W]:
    cumulative sums of ``not_mask`` (default all ones) along H and W,
    optionally normalised to [0, scale], each divided by
    temperature^(2 floor(i / 2) / num_pos_feats), sin and cos interleaved;
    the y embedding's channels first."""
    if scale is not None and not normalize:
        raise ValueError("normalize should be True if scale is passed")
    if scale is None:
        scale = 2 * math.pi
    b, h, w = mask_shape
    if not_mask is None:
        not_mask = torch.ones(b, h, w)
    y_embed = torch.cumsum(not_mask.float(), dim=1)
    x_embed = torch.cumsum(not_mask.float(), dim=2)
    if normalize:
        eps = 1e-6
        y_embed = y_embed / (y_embed[:, -1:, :] + eps) * scale
        x_embed = x_embed / (x_embed[:, :, -1:] + eps) * scale
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=y_embed.device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor") / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])],
                        dim=4).reshape(b, h, w, -1)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]), torch.cos(pos_y[..., 1::2])],
                        dim=4).reshape(b, h, w, -1)
    return torch.cat([pos_y, pos_x], dim=3).permute(0, 3, 1, 2)
