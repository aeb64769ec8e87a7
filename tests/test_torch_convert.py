"""Weights into the port: ``state_dict_from_jax`` against ``sod_tpu``'s
``export_maskformer`` (exact), loading into the port's modules, torch
checkpoints, and the seeded random init."""
import jax
import numpy as np
import torch

from sod_tpu.models.convert import export_maskformer
from sod_tpu.models.maskformer import MaskFormerConfig as JaxMaskFormerConfig
from sod_tpu.models.maskformer import maskformer_init
from sod_tpu.models.vit import ViTConfig as JaxViTConfig
from sod_tpu_torch.models.convert import load_torch_state_dict, state_dict_from_jax
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, random_state_dict
from sod_tpu_torch.models.vit import ViTConfig

VIT = dict(patch_size=8, embed_dim=64, depth=2, n_heads=2, pos_grid=4)


def _jax_tree():
    cfg = JaxMaskFormerConfig(n_queries=4, n_decoder_layers=2,
                              vit=JaxViTConfig(**VIT))
    return jax.tree.map(np.asarray, maskformer_init(jax.random.key(0), cfg))


def _port_model():
    return MaskFormer(MaskFormerConfig(n_queries=4, n_decoder_layers=2,
                                       vit=ViTConfig(**VIT)))


def test_state_dict_from_jax_equals_export_maskformer():
    tree = _jax_tree()
    ours, theirs = state_dict_from_jax(tree), export_maskformer(tree)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].dtype == theirs[k].dtype and np.array_equal(ours[k], theirs[k]), k


def test_carried_weights_fill_every_port_parameter():
    sd = state_dict_from_jax(_jax_tree())
    model = _port_model()
    assert set(sd) == set(model.state_dict())
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()})
    got = model.state_dict()
    for k, v in sd.items():
        assert np.array_equal(got[k].numpy(), v), k


def test_load_torch_state_dict_unwraps_model(tmp_path):
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in state_dict_from_jax(_jax_tree()).items()}
    fp = str(tmp_path / "latest_model.pt")
    torch.save({"model": sd, "optimizer": {}, "n_epochs": 12}, fp)
    loaded = load_torch_state_dict(fp)
    assert list(loaded) == list(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    _port_model().load_state_dict(loaded)


def test_random_state_dict_is_seeded_with_sod_tpu_distributions():
    model = _port_model()
    a, b = random_state_dict(model, 0), random_state_dict(model, 0)
    assert set(a) == set(model.state_dict())
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["query_embed"], random_state_dict(model, 1)["query_embed"])
    assert torch.all(a["encoder.blocks.0.norm1.weight"] == 1)
    assert torch.all(a["decoder.norm.bias"] == 0)
    assert torch.all(a["encoder.blocks.1.attn.qkv.bias"] == 0)
    assert torch.all(a["encoder.cls_token"] == 0)
    assert abs(float(a["encoder.blocks.0.mlp.fc1.weight"].std()) - 0.02) < 0.004
    bound = 1 / np.sqrt(64)
    w = a["decoder.layers.0.linear1.weight"]
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.9 * bound
