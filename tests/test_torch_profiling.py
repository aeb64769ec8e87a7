"""The port's span recorder (``sod_tpu_torch/utils/profiling.py``) and the
spans of the train step (``train/step.py``), on the CPU with a tiny
model: off, ``span`` hands back one shared no-op object and records
nothing; on (``recording()`` or a CPU ``torch.profiler`` session), names,
parents, steps and nesting, a stack per thread; the phases each step
records, ``grad_sync`` under a 1-rank data mesh; a step's numbers bit-equal
with recording on and off; ``trace``'s ``spans.json``."""
import contextlib
import json
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sod_tpu_torch.config import Config
from sod_tpu_torch.models.maskformer import MaskFormer, MaskFormerConfig, random_state_dict
from sod_tpu_torch.models.vit import ViTConfig
from sod_tpu_torch.train.optim import build_optimizer
from sod_tpu_torch.train.step import METRIC_KEYS, make_train_step
from sod_tpu_torch.utils import profiling

PHASES = {"step", "forward", "encoder", "criterion", "backward", "optimizer", "grad_sync"}


@pytest.fixture(autouse=True)
def fresh_recorder():
    profiling.reset()
    yield
    profiling.reset()


def _model(seed=3):
    cfg = MaskFormerConfig(n_queries=4, n_decoder_layers=2, use_binary_classifier=True,
                           vit=ViTConfig(patch_size=8, embed_dim=64, depth=2, n_heads=2,
                                         pos_grid=4))
    model = MaskFormer(cfg)
    model.load_state_dict(random_state_dict(model, seed))
    return model


def _batch(seed=1, b=4):
    r = np.random.default_rng(seed)
    gt = np.zeros((b, 2, 32, 32), np.uint8)
    valid = np.zeros((b, 2), bool)
    for i in range(b - 1):
        y, x = r.integers(0, 14, 2)
        gt[i, 0, y:y + 12, x:x + 14] = 1
        valid[i, 0] = True
    return {"image": torch.from_numpy(r.integers(0, 256, (b, 32, 32, 3), dtype=np.uint8)),
            "gt_masks": torch.from_numpy(gt), "gt_valid": torch.from_numpy(valid),
            "labels": torch.tensor([5, 9, 5, 9][:b], dtype=torch.int32)}


def _step(accum=1, mode="averaged"):
    cfg = Config(batch_size=4, lr=1e-3, lr_warmup_duration=0, n_epochs=2,
                 compute_dtype="float32", grad_accum_steps=accum, grad_accum_mode=mode)
    model = _model()
    opt = build_optimizer(cfg, model.parameters(), 2)
    return model, opt, make_train_step(cfg, model, opt, accum_steps=accum, mode=mode)


def _tree(recs):
    """(name, parent's name) of each record, in the order they opened."""
    by_id = {r.id: r for r in recs}
    return [(r.name, by_id[r.parent].name if r.parent is not None else None) for r in recs]


# ------------------------------------------------------------ the recorder

@pytest.mark.parametrize("name,counts", [("step", {"rows": 4, "micro": 1}), ("forward", {})])
def test_off_returns_the_shared_no_op_and_records_nothing(name, counts):
    assert not torch.autograd.profiler._is_profiler_enabled
    first, second = profiling.span(name, **counts), profiling.span("other")
    assert first is second
    with first as got:
        with profiling.span("inner"):
            torch.ones(3).sum()
    assert got is None
    assert profiling.records() == []


@pytest.mark.parametrize("switch", ["recording", "profiler"])
def test_names_parents_steps_and_nesting(switch):
    on = (profiling.recording() if switch == "recording"
          else profile(activities=[ProfilerActivity.CPU]))
    with on as prof:
        for _ in range(2):
            with profiling.span("outer", rows=8):
                with profiling.span("a"):
                    with profiling.span("leaf"):
                        torch.ones(4).sum()
                with profiling.span("b"):
                    pass
    recs = profiling.records()
    assert _tree(recs) == [("outer", None), ("a", "outer"), ("leaf", "a"), ("b", "outer")] * 2
    assert recs[0].counts == {"rows": 8} and recs[1].counts == {}
    first, second = recs[:4], recs[4:]
    assert len({r.step for r in first}) == 1 and len({r.step for r in second}) == 1
    assert first[0].step == first[0].id and second[0].step != first[0].step
    for r in recs:
        parent = next((p for p in recs if p.id == r.parent), None)
        if parent is not None:
            assert parent.t0_ns <= r.t0_ns <= r.t1_ns <= parent.t1_ns
        assert r.device_ms() is None                       # no CUDA here
        a, b = r.wall_ns()
        assert b - a == r.t1_ns - r.t0_ns
    if switch == "profiler":
        names = {e.key for e in prof.key_averages()}
        assert {"outer", "a", "leaf", "b"} <= names
    assert profiling.span("after") is profiling.span("again")


def test_two_threads_keep_separate_stacks():
    barrier = threading.Barrier(2, timeout=30)
    errors = []

    def work(tag):
        try:
            with profiling.span(f"outer_{tag}"):
                barrier.wait()                  # both outer spans open at once
                with profiling.span(f"inner_{tag}"):
                    barrier.wait()
        except Exception as e:                  # surfaced below
            errors.append(e)

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = {r.name: r for r in profiling.records()}
    for tag in "xy":
        assert recs[f"inner_{tag}"].parent == recs[f"outer_{tag}"].id
        assert recs[f"inner_{tag}"].step == recs[f"outer_{tag}"].step
    assert recs["outer_x"].step != recs["outer_y"].step
    assert recs["outer_x"].parent is None and recs["outer_y"].parent is None


# ------------------------------------------------------------ the train step

STEP_TREES = {
    "plain": (1, "averaged", ["forward", "criterion", "backward", "optimizer"]),
    "averaged_2": (2, "averaged", ["forward", "criterion", "backward"] * 2 + ["optimizer"]),
    "exact_2": (2, "exact", ["forward", "forward", "criterion", "backward"]
                + ["forward", "criterion", "backward"] * 2 + ["optimizer"]),
}


@pytest.mark.parametrize("case", sorted(STEP_TREES))
def test_step_records_its_phases(case):
    accum, mode, children = STEP_TREES[case]
    _, _, step = _step(accum, mode)
    with profiling.recording():
        step(_batch())
    recs = profiling.records()
    want = [("step", None)]
    for c in children:                 # MaskFormer's encoder call opens inside each forward
        want += [(c, "step")] + ([("encoder", "forward")] if c == "forward" else [])
    assert _tree(recs) == want
    assert recs[0].counts == {"rows": 4, "micro": accum}
    assert {r.step for r in recs} == {recs[0].id}
    assert {r.name for r in recs} <= PHASES


@pytest.mark.parametrize("case", sorted(STEP_TREES))
def test_step_is_bit_equal_with_recording_on_and_off(case):
    accum, mode, _ = STEP_TREES[case]
    runs = []
    for on in (False, True):
        model, opt, step = _step(accum, mode)
        with profiling.recording() if on else contextlib.nullcontext():
            metrics = step(_batch())
        runs.append(({k: metrics[k].clone() for k in METRIC_KEYS},
                     {k: v.clone() for k, v in model.state_dict().items()},
                     [m.clone() for m in opt.mu] + [v.clone() for v in opt.nu]))
    (m0, p0, s0), (m1, p1, s1) = runs
    assert profiling.records()
    for k in METRIC_KEYS:
        assert torch.equal(m0[k], m1[k]), k
    for k in p0:
        assert torch.equal(p0[k], p1[k]), k
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))


def test_step_under_a_data_mesh_records_grad_sync():
    """A 1-rank gloo mesh, ZeRO-1: the layout's gather, the metrics'
    all-reduce, and the reduce and publish inside ``optimizer``."""
    from sod_tpu_torch.parallel.fsdp import StateLayout
    from sod_tpu_torch.parallel.mesh import make_mesh, shard_batch

    cfg = Config(batch_size=4, lr=1e-3, lr_warmup_duration=0, n_epochs=2,
                 compute_dtype="float32")
    mesh = make_mesh(1, "cpu")
    try:
        model = _model()
        layout = StateLayout(model, mesh, "zero1")
        opt = build_optimizer(cfg, layout.tensors, 2)
        step = make_train_step(cfg, model, opt, layout=layout)
        with profiling.recording():
            step(shard_batch(_batch(), mesh))
    finally:
        torch.distributed.destroy_process_group()
    assert _tree(profiling.records()) == [
        ("step", None), ("grad_sync", "step"), ("forward", "step"), ("encoder", "forward"),
        ("criterion", "step"),
        ("backward", "step"), ("grad_sync", "step"), ("optimizer", "step"),
        ("grad_sync", "optimizer"), ("grad_sync", "optimizer")]


def test_trace_writes_spans_json(tmp_path):
    _, _, step = _step()
    with profiling.recording():
        step(_batch())                          # reset by trace()
    with profiling.trace(str(tmp_path)):
        step(_batch(2))
    with open(tmp_path / "spans.json") as f:
        doc = json.load(f)
    assert (tmp_path / "trace.json").exists()
    spans = doc["spans"]
    assert [s["name"] for s in spans] == ["step", "forward", "encoder", "criterion", "backward",
                                          "optimizer"]
    ids = {s["id"] for s in spans}
    for s in spans:
        assert s["start_ns"] <= s["end_ns"] and s["device_ms"] is None
        assert s["step"] == spans[0]["id"] and (s["parent"] is None or s["parent"] in ids)
    assert spans[0]["counts"] == {"rows": 4, "micro": 1}
    assert not torch.autograd.profiler._is_profiler_enabled
    assert profiling.span("x") is profiling.span("y")
