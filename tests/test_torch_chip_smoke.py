"""``chip_smoke.py`` off the card: what it must refuse to do."""
import sys

import numpy as np
import pytest

import chip_smoke


class _Service:
    """Answers ``model_step`` as the port's service would."""

    class mcfg:
        n_queries = 20

        class vit:
            depth = 12

    def model_step(self, arr):
        return np.zeros(arr.shape[:2], np.uint8), np.zeros(20, np.float32)


class _Cfg:
    eval_image_size = 224


def test_requests_phase_fails_without_pil(monkeypatch):
    """Phase 5 posts real ``/predict`` requests or fails: a missing PIL (or
    yaml) must not turn it into a pass through ``model_step``."""
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        chip_smoke.requests_phase(_Service(), _Cfg())


def test_main_exits_without_a_card(monkeypatch, capsys):
    """No CUDA device: exit non-zero before printing any result."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main()
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_k2_bound_and_phase_6_shapes():
    """The K2 bound as a host function of (B, H, N, d, valid keys): 0.00766 ms
    forward and 0.0191 ms backward at the train shape (operations at 989
    TFLOP/s), fewer operations under a key mask; phase 6's shape list holds
    the eval shape and the tile edges, at every head dim."""
    import chip_smoke as cs

    bound = cs.k2_bound(8, 6, 785, 64)
    assert bound["fwd"]["bound_by"] == bound["bwd"]["bound_by"] == "operations"
    assert abs(bound["fwd"]["bound_ms"] - 0.00766) <= 0.01 * 0.00766
    assert abs(bound["bwd"]["bound_ms"] - 0.0191) <= 0.01 * 0.0191
    assert cs.k2_bound(*cs.K2_TRAIN_SHAPE) == bound
    full = cs.k2_bound(*cs.K2_EVAL_SHAPE)["fwd"]["bound_ms"]
    half = cs.k2_bound(*cs.K2_EVAL_SHAPE, valid_keys=16 * 2501 // 2)["fwd"]["bound_ms"]
    assert abs(half - full / 2) <= 1e-9
    # bytes bind where there is one key per query
    assert cs.k2_bound(2, 3, 1, 64)["fwd"]["bound_by"] == "bytes"
    assert cs.K2_EVAL_SHAPE[:3] == (16, 6, 2501) and cs.K2_EVAL_SHAPE[:3] in cs.K2_SHAPES
    assert cs.K2_TRAIN_SHAPE[:3] in cs.K2_SHAPES
    assert {n for _, _, n in cs.K2_SHAPES} == {1, 63, 64, 65, 129, 785, 2501}
    assert cs.K2_HEAD_DIMS == (32, 64, 128)
    # the vitg14reg-train-b8 cell's attention, at its own head dim only
    assert cs.K2_VITG_SHAPE == (8, 24, 1 + 4 + 37 * 37, 64)
    assert cs.K2_CASES[-1] == cs.K2_VITG_SHAPE
    assert len(cs.K2_CASES) == len(cs.K2_SHAPES) * len(cs.K2_HEAD_DIMS) + 1
    vitg = cs.k2_bound(*cs.K2_VITG_SHAPE)
    assert vitg["fwd"]["bound_by"] == vitg["bwd"]["bound_by"] == "operations"
    assert abs(vitg["fwd"]["bound_ms"] / bound["fwd"]["bound_ms"]
               - 24 * 1374 ** 2 / (6 * 785 ** 2)) <= 1e-9
    mask = cs._canvas_mask(np.random.default_rng(0), 4, 2501)
    assert mask.shape == (4, 2501) and mask[:, 0].all() and not mask.all()


def test_gemm_bound_and_phase_3_shapes():
    """The GEMM bound as a host function of (M, N, K, epilogue, LN, a's and
    res's bytes): K1's QKV at B=8 (M 7168, N 1152, K 384) does 6.34 GFLOP
    (0.00641 ms at 989 TFLOP/s) and moves 22.9 MB (0.00684 ms at 3.35 TB/s),
    so bytes bound it; an f32 output or input moves more.  Phase 3 times
    the four forms at K1's B=1 and B=8 rows and K4's train and eval rows,
    and sweeps the fused block to d 768 and 1024."""
    import chip_smoke as cs

    b = cs.gemm_bound(7168, 1152, 384, "bias_bf16", True, 2, 0)
    assert b["bound_by"] == "bytes"
    assert abs(b["bound_ms"] - 22908672 / 3.35e12 * 1e3) <= 1e-12
    flops_ms = 2 * 7168 * 1152 * 384 / 989e12 * 1e3
    assert abs(flops_ms - 0.00641) <= 1e-5 and b["bound_ms"] > flops_ms
    f32 = cs.gemm_bound(7168, 1152, 384, "res_f32", False, 2, 2)
    assert f32["bound_ms"] > b["bound_ms"]
    long_k = cs.gemm_bound(4096, 4096, 8192, "bias_bf16", False, 2, 0)
    assert long_k["bound_by"] == "operations"
    assert set(cs.GEMM_ROWS) == {896, 7168, 6336, 40960}
    assert cs.GEMM_REPORT_ROWS in cs.GEMM_ROWS
    assert [f[1] for f in cs.GEMM_FORMS] == ["bias_bf16", "res_f32", "gelu_bf16", "res_bf16"]
    assert {d for d, _ in cs.K1_WIDTHS} >= {768, 1024}
    assert all(d // h in (32, 64, 128) for d, h in cs.K1_WIDTHS)


def test_linear_bound_and_phase_3_linear_shapes():
    """The bf16 linear's bound at the train cell's shapes: fc1 at 50240
    rows does three products of 59.3 GFLOP (0.180 ms at 989 TFLOP/s)
    against 0.573 GB (0.171 ms at 3.35 TB/s), so operations bind; the
    patch embedding, without dx, moves 116 MB for two products, so bytes
    bind; the f32-bias form alone counts its bias at 4
    bytes.  Phase 3 times every ViT linear, the patch embedding (no dx) and
    the decoder's K/V, query and FFN products at the cell's rows, then the
    DINOv2 ViT-g/14-reg cell's qkv, proj, w12, w3, adapter, decoder K/V and
    query products at B=8's rows (10992, 10952, 160: no multiple of 64),
    each a shape the tensor-core rule takes."""
    import chip_smoke as cs
    from sod_tpu_torch.ops import gemm as G

    b = cs.linear_bound(50240, 1536, 384)
    assert b["bound_by"] == "operations"
    assert abs(b["bound_ms"] - 6 * 50240 * 1536 * 384 / 989e12 * 1e3) <= 1e-12
    n_bytes = 6 * 50240 * 384 + 6 * 50240 * 1536 + 8 * 1536 * 384 + 8 * 1536
    assert n_bytes / 3.35e12 * 1e3 < b["bound_ms"]
    m, n, k = 50176, 384, 192                      # the patch embedding: 116 MB
    no_dx = cs.linear_bound(m, n, k, dx=False)
    assert no_dx["bound_by"] == "bytes"
    n_bytes = 4 * m * k + 4 * m * n + 2 * n * k + 4 * n * k + 8 * n
    assert abs(no_dx["bound_ms"] - n_bytes / 3.35e12 * 1e3) <= 1e-12
    assert cs.linear_bound(m, n, k)["bound_ms"] > no_dx["bound_ms"]
    f32 = cs.gemm_bound(64, 64, 64, "f32bias_bf16", False, 2, 0)["bound_ms"]
    bf = cs.gemm_bound(64, 64, 64, "bias_bf16", False, 2, 0)["bound_ms"]
    assert abs((f32 - bf) - 2 * 64 / 3.35e12 * 1e3) <= 1e-15
    assert [s[0] for s in cs.LINEAR_SHAPES] == ["qkv", "proj", "fc1", "fc2", "patch",
                                                "dec_kv", "dec_q", "dec_fc1", "dec_fc2",
                                                "g_qkv", "g_proj", "g_w12", "g_w3",
                                                "g_adapter", "g_dec_kv", "g_dec_q"]
    assert all(G.tc_shape(m, n, k) for _, m, n, k, _ in cs.LINEAR_SHAPES)
    assert {m for _, m, _, _, _ in cs.LINEAR_SHAPES} == {64 * 785, 64 * 784, 64 * 20,
                                                         8 * 1374, 8 * 1369, 8 * 20}
    assert {m % 64 for _, m, _, _, _ in cs.LINEAR_SHAPES} == {0, 48, 8, 32}
    assert [s[0] for s in cs.LINEAR_SHAPES if not s[4]] == ["patch"]


def test_s8_form_bound_and_phase_14_products():
    """K8's four s8 products at B=8 (7168 rows, d 384, hidden 1536) are bound
    by their bytes at the H100's 3.35 TB/s: QKV 22.5 MB against 6.34 GOP
    (3.2 us at 1,979 TOP/s), proj 22.2 MB, fc1 56.3 MB and fc2 61.8 MB, the
    f32 residual and hidden that K8's rounding points keep; phase 14 times
    them at those shapes, each beside the bf16 form of the same product, and
    holds K8's chain to at most six launches a block."""
    import chip_smoke as cs

    want = {"qkv": 22474752, "proj": 22170624, "fc1": 56343552, "fc2": 61836288}
    for form, n, k, bf16_form in cs.S8_FORMS:
        b = cs.s8_form_bound(form, cs.S8_ROWS, n, k)
        assert b["bound_by"] == "bytes", form
        assert abs(b["bound_ms"] - want[form] / 3.35e12 * 1e3) <= 1e-12, form
        assert bf16_form in [f[1] for f in cs.GEMM_FORMS]
    ops_ms = 2 * 7168 * 1152 * 384 / 1979e12 * 1e3
    assert abs(ops_ms - 0.0032) <= 1e-4
    assert [f[0] for f in cs.S8_FORMS] == ["qkv", "proj", "fc1", "fc2"]
    assert cs.S8_ROWS == 8 * 896 == cs.GEMM_REPORT_ROWS
    assert cs.K8_MAX_LAUNCHES == 6
    assert cs.S8["source"] == "sod_tpu_torch/csrc/vit_block.cuh"
    assert cs.S8["replaces"].startswith("sod_tpu/ops/fused_block_int8.py:")


def test_maskgen_phase_is_run_and_fails_without_a_card(tmp_path, monkeypatch):
    """Phase 16 (pseudo-mask generation at full width) is part of ``main``,
    writes its synthetic images, and off the card fails instead of
    generating on the CPU."""
    import inspect

    import chip_smoke as cs

    assert "maskgen_check()" in inspect.getsource(cs.main)
    paths = cs.write_maskgen_images(str(tmp_path), 3)
    from PIL import Image

    sizes = [Image.open(p).size for p in paths]
    assert len(paths) == 3 and all(150 <= s <= 400 for wh in sizes for s in wh)
    assert cs.MASKGEN_IMAGES == 32 and cs.MASKGEN_LABEL_AGREEMENT == 0.98
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        cs.maskgen_check()


@pytest.mark.parametrize("check,match", [
    ("refine_check", "launched K1 0 times"),
    ("pool_check", "did not come up"),
    ("tools_check", "cli.smoke --device cuda exited 1")])
def test_refinement_pool_and_tools_phases_are_run_and_fail_without_a_card(check, match,
                                                                          monkeypatch):
    """Phases 17-19 (refinement through ``/predict?refine=1``, the two-worker
    pool, the smoke and export CLIs) are part of ``main``, beside the bf16
    service; off the card each fails instead of passing on the CPU: the
    refinement sees no K1 launch (the CPU runs K1's plain version), the
    pool's server exits without a card, the smoke CLI fails its device
    phase."""
    import inspect

    import chip_smoke as cs
    from sod_tpu_torch.config import Config
    from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, random_state_dict
    from sod_tpu_torch.models.vit import ViTConfig
    from sod_tpu_torch.serving import inference

    assert f"{check}(svc, cfg)" in inspect.getsource(cs.main)
    assert cs.REFINE_SIZES[-1] == (4000, 3000) and cs.POOL_WORKERS == 2
    tcfg = MaskFormerConfig(n_queries=4, n_decoder_layers=2, vit=ViTConfig(
        patch_size=8, embed_dim=32, depth=2, n_heads=2, pos_grid=4))
    monkeypatch.setattr(inference, "config_from", lambda cfg: tcfg)
    cfg = Config(eval_image_size=32, compute_dtype="float32", micro_batch=False)
    svc = inference.SelfMaskInference(cfg=cfg, state_dict=random_state_dict(MaskFormer(tcfg), 0),
                                      device="cpu", warmup=False)
    with pytest.raises(AssertionError, match=match):
        getattr(cs, check)(svc, cfg)


@pytest.mark.parametrize("check", ["resnet_service_check", "resnet_train_check",
                                   "non_bc_train_check", "hungarian_branch_check",
                                   "vit_helpers_check"])
def test_model_options_phase_is_run_and_fails_without_a_card(check):
    """Phase 20 (the ResNet-50 service and train step, the non-bc step, the
    Hungarian branch, the ViT helpers) is part of ``main``; off the card
    each of its checks fails instead of running on the CPU."""
    import inspect

    import chip_smoke as cs
    from sod_tpu_torch.config import load_config

    assert "model_options_check()" in inspect.getsource(cs.main)
    assert f"{check}(cfg)" in inspect.getsource(cs.model_options_check)
    with pytest.raises((RuntimeError, AssertionError)):
        getattr(cs, check)(load_config(cs.CONFIG))


@pytest.mark.parametrize("check", ["exact_mode_check", "remat_check", "async_checkpoint_check",
                                   "visualizer_check", "process_loader_check"])
def test_training_options_phase_is_run_and_fails_without_a_card(check):
    """Phase 21 (exact accumulation on K2 and on K3 + K4, remat, the async
    checkpoint through ``cli.train``, the visualizer hooks, the process
    loader) is part of ``main``; off the card each of its checks fails
    instead of running on the CPU."""
    import inspect

    import chip_smoke as cs
    from sod_tpu_torch.config import load_config

    assert "training_options_check()" in inspect.getsource(cs.main)
    source = inspect.getsource(cs.training_options_check)
    assert f"{check}(" in source
    args = () if check == "async_checkpoint_check" else (load_config(cs.CONFIG),)
    with pytest.raises((RuntimeError, AssertionError)):
        getattr(cs, check)(*args)


def test_data_mesh_phase_is_run_and_fails_without_a_card():
    """Phase 22 (the data mesh at a world size of 1 over NCCL: the default,
    fused ZeRO-1 and FSDP-full steps, the Evaluator, MaskGenerator) is part
    of ``main``; off the card it fails before any process group starts,
    instead of falling back to gloo on the CPU."""
    import inspect

    import torch

    import chip_smoke as cs

    assert "data_mesh_check()" in inspect.getsource(cs.main)
    source = inspect.getsource(cs.data_mesh_check)
    for part in ("default step", "use_fused_train, zero1", "fsdp full", "Evaluator",
                 "MaskGenerator"):
        assert part in source
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        cs.data_mesh_check()
    assert not torch.distributed.is_initialized()


def test_model_layouts_phase_is_run_and_fails_without_a_card():
    """Phase 23 (the model-sharding layouts at one rank over NCCL: TP, PP,
    SP, p3 and sptp steps against the step with no mesh, the two-rank
    arithmetic in one process, the SP Evaluator, ``cli.train --tp 2``) is
    part of ``main`` after phase 22; off the card it fails before any
    process group starts, instead of falling back to gloo on the CPU."""
    import inspect

    import torch

    import chip_smoke as cs

    main = inspect.getsource(cs.main)
    assert main.index("data_mesh_check()") < main.index("model_layouts_check()")
    source = inspect.getsource(cs.model_layouts_check)
    for part in ("make_mesh_2d(1, 1", "make_mesh_pp(1, 1", "make_mesh_sp(1, 1",
                 "make_mesh_3d(1, 1, 1", "make_mesh_sptp(1, 1, 1", "pp_microbatches=2",
                 "p3_merge_blocks(split)", "_two_rank_arithmetic", "Evaluator", "--tp"):
        assert part in source, part
    assert cs.LAYOUT_MAX_ABS == 2e-5 and cs.LAYOUT_MAX_REL == 1e-4
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        cs.model_layouts_check()
    assert not torch.distributed.is_initialized()


def test_vitg_phase_is_run_and_fails_without_a_card():
    """Phase 25 (one training step of the vitg14reg-train-b8 cell's model,
    its linear_tc and K2 launches counted) is part of ``main``, and its
    count feeds the kernel line's ViT-g linear rows; off the card it fails
    before it draws the 1.14B weights."""
    import inspect

    import chip_smoke as cs

    source = inspect.getsource(cs.main)
    assert "vitg = vitg_train_check()" in source
    assert 'vitg["tc"]' in source and 'main_linears["forward B=8"]' in source
    with pytest.raises((RuntimeError, AssertionError)):
        cs.vitg_train_check()


def test_graphed_phase_is_run_and_fails_without_a_card():
    """Phase 26 (eager and CUDA-graph steps of both train cells' models from
    one state, bit for bit) is part of ``main`` and runs both cells' batch
    sizes; off the card it fails at its first upload, before it draws any
    weights."""
    import inspect

    import chip_smoke as cs

    assert "graphed_step_check()" in inspect.getsource(cs.main)
    assert {cell: b for cell, (b, _) in cs.GRAPH_CELLS.items()} == {
        "vits8-train-b64": 64, "vitg14reg-train-b8": 8}
    assert cs.GRAPH_STEPS >= 3
    with pytest.raises((RuntimeError, AssertionError)):
        cs.graphed_step_check()
