"""The ViT-g/14-reg cell's pieces on the CPU: its operation count against a
hand count, the linear products ``drivers/train_vitg.py`` bounds, its
counters at the published shapes, the three readers it adds on synthetic
runs, and its reference's names against the program's."""
from types import SimpleNamespace

import pytest
import torch

from sodbench import flops, flops_dinov2 as fd, harness
from sodbench.reference import dinov2
from sodbench.trace import TraceSummary

from sod_tpu_torch.utils import profiling

CELL, CONFIG = "vitg14reg-train-b8", "selfmask-dinov2-vitg14reg-nq20"
HW = (518, 518)


def test_operation_count_by_hand():
    """10.76 TFLOP a training image: 1374 tokens (CLS, 4 registers, 37 x 37
    patches), 40 blocks of qkv 1536 x 4608, proj 1536 x 1536, w12 1536 x
    8192, w3 4096 x 1536 and attention, the patch embedding, the adapter,
    SelfMask's decoder over 1369 tokens and its heads, three times."""
    n, p = 1374, 1369
    block_macs = n * (1536 * 4608 + 1536 * 1536 + 1536 * 8192 + 4096 * 1536) \
        + 2 * 24 * n * n * 64
    enc = 2 * (p * 588 * 1536 + 40 * block_macs)
    assert fd.encoder_flops(HW) == enc
    fwd = enc + 2 * p * 1536 * 384 + flops.decoder_flops(p) + flops.heads_flops(4 * p)
    assert fd.forward_flops(HW) == fwd
    assert fd.train_flops(HW) == 3 * fwd
    assert fd.train_flops(HW) == pytest.approx(10.76e12, rel=0.01)
    # the 40 blocks hold 99.7% of the forward
    assert 40 * 2 * block_macs / fwd == pytest.approx(0.997, abs=0.001)


def test_linear_products_of_a_step():
    """221 linears on the tensor cores a step: 4 a block, the adapter, 10 a
    decoder layer; each forward, dW, and dx but for the first layer's
    self-attention value (the zero target); rows 10992, 10952 and 160."""
    shapes = fd.linear_shapes(8, HW)
    assert len(shapes) == 40 * 4 + 1 + 6 * 10 == 221
    assert {m for m, *_ in shapes} == {8 * 1374, 8 * 1369, 8 * 20}
    assert sum(not dx for *_, dx in shapes) == 1
    prods = fd.linear_products(10992, 8192, 1536, True)
    assert [p[0] for p in prods] == [2 * 10992 * 8192 * 1536] * 3
    assert prods[2][1] == 2 * 10992 * 8192 + 2 * 10992 * 1536 + 4 * 8192 * 1536
    bound = fd.linear_bound_s(8, HW)
    ops = sum(2 * m * n * k * (3 if dx else 2) for m, n, k, dx in shapes)
    # the block products bind on operations; the decoder's small ones on bytes
    assert ops / 989e12 < bound < 1.01 * ops / 989e12


def _driver(steps=4):
    from sodbench.drivers import train_vitg
    from sodbench.tests.tiny import tiny_ctx

    d = train_vitg.Driver(tiny_ctx(CONFIG, "train_steps_vitg"))
    d.losses = [torch.zeros(())] * steps
    d.window = {"t0_ns": 0, "t1_ns": 2_000_000_000}
    d.linears = {"tc": 221.0, "f32": 1.0}
    return d


def test_driver_counters_at_the_published_shapes():
    c = _driver().counters()
    assert (c["kind"], c["steps"], c["images"], c["window_s"]) == ("train", 4, 32, 2.0)
    assert c["flops"] == 32 * fd.train_flops(HW)
    assert c["k2_fwd_bound_s"] == flops.bound_s(*flops.k2_forward(8, 24, 1374, 64))
    assert c["k2_bwd_bound_s"] == flops.bound_s(*flops.k2_backward(8, 24, 1374, 64))
    assert c["gemm_bound_s_per_step"] == fd.linear_bound_s(8, HW)
    assert (c["tc_linears_per_step"], c["f32_linears_per_step"]) == (221.0, 1.0)


def test_upload_hands_over_the_pooled_batch():
    """``_upload`` gives the pooled batch's tensors on the driver's device,
    cycling through the pool (off the card nothing is pinned)."""
    d = _driver()
    d.pool = [{"image": torch.full((2, 3), i, dtype=torch.uint8)} for i in range(3)]
    assert [int(d._upload(i)["image"][0, 0]) for i in range(5)] == [0, 1, 2, 0, 1]
    assert d._upload(0)["image"].device == d.dev


def test_cell_is_listed_with_its_config_and_traffic():
    man = harness.manifest()
    cell = harness.by_name(man["workloads"], CELL, "workload")
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "train_steps_vitg", 1)
    cfg = harness.config_file(man, CONFIG)
    base = harness.config_file(man, "selfmask-vits8-nq20")["config"]
    changed = {k for k in base if base[k] != cfg["config"][k]}
    assert set(cfg["config"]) == set(base)
    assert changed == {"arch", "patch_size", "train_image_size", "eval_image_size",
                       "batch_size", "num_layers"}
    assert cfg["config"]["num_layers"] == list(range(40)) and cfg["reduced"] == {}
    per_layer = {m["name"]: m for m in man["per_layer"]}
    for name in ("idle.train", "mfu.train", "k2_roofline.train", "launches.train",
                 "fwd_ms.train", "bwd_ms.train", "enc_ms.train", "f32_linears.train",
                 "gemm_roofline.train"):
        assert CELL in per_layer[name]["workloads"], name
    assert per_layer["enc_ms.train"]["workloads"] == ["vits8-train-b64", CELL]
    assert harness.limits_file(CELL)["checks"]


def _read(name, run):
    return harness.metric_reader(name).read(name, run)


def test_f32_linears_reader():
    run = SimpleNamespace(counters={"f32_linears_per_step": 1.0}, trace=None)
    assert _read("f32_linears.train", run) == 1.0
    assert _read("f32_linears.train", SimpleNamespace(counters={}, trace=None)) is None


def test_gemm_roofline_reader():
    """4 steps of a 10 ms bound over 80 ms of gemm_kernel launches: 50%;
    other kernels and the reduction of TN's partials are not counted."""
    events = [("void sod::gemm_kernel<11, false, __nv_bfloat16, 2, 128, false, 0>(CUtensorMap)",
               i * 10_000_000, i * 10_000_000 + 8_000_000) for i in range(10)]
    events += [("void sod::reduce_partials_kernel(float const*, int, unsigned long, float*)",
                200_000_000, 250_000_000),
               ("void sod::gemm_s8_kernel<0>(CUtensorMap)", 300_000_000, 350_000_000)]
    trace = TraceSummary(events, 0, 400_000_000)
    run = SimpleNamespace(trace=trace, counters={"steps": 4, "gemm_bound_s_per_step": 0.01})
    assert _read("gemm_roofline.train", run) == pytest.approx(50.0)
    run.counters = {"steps": 4}
    assert _read("gemm_roofline.train", run) is None
    run.counters, run.trace = {"steps": 4, "gemm_bound_s_per_step": 0.01}, None
    assert _read("gemm_roofline.train", run) is None


def test_enc_ms_reader_gives_nothing_without_encoder_spans():
    """On the CPU the spans carry no CUDA events, and a program without an
    ``encoder`` span (the parent's) gives nothing either."""
    profiling.reset()
    try:
        with profiling.recording():
            for _ in range(2):
                with profiling.span("step", rows=8, micro=1):
                    with profiling.span("forward"):
                        with profiling.span("encoder"):
                            pass
        recs = profiling.records()
        t0 = min(r.wall_ns()[0] for r in recs) - 1000
        t1 = max(r.wall_ns()[1] for r in recs) + 1000
        run = SimpleNamespace(counters={"kind": "train", "steps": 2},
                              trace=TraceSummary([("k", t0, t1)], t0, t1))
        assert _read("enc_ms.train", run) is None
        profiling.reset()
        assert _read("enc_ms.train", run) is None
    finally:
        profiling.reset()


def test_reference_names_every_tensor_of_the_program():
    from sod_tpu_torch.config import Config
    from sod_tpu_torch.models.maskformer import MaskFormer, config_from

    with torch.device("meta"):
        sd = MaskFormer(config_from(Config(arch="dinov2_vitg14_reg", patch_size=14))).state_dict()
    specs = {n: tuple(s) for n, s, *_ in dinov2.param_specs()}
    assert specs == {k: tuple(v.shape) for k, v in sd.items()}
    inits = {n: init for n, _, init, _ in dinov2.param_specs()}
    assert inits["encoder.blocks.7.ls2.gamma"] == "ones"
    assert inits["encoder.register_tokens"] == inits["encoder.cls_token"] == "normal"
