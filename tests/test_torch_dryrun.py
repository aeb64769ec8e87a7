"""The port's multi-card dryrun (``sod_tpu_torch/dryrun.py``) on 8 gloo ranks
against ``sod_tpu``'s one-device run, and ``entry()`` against
``__graft_entry__.entry()``.

One spawn of 8 ranks (the reference's own ``__main__`` size, the only one at
which phases 9 and 10 run) from ``sod_tpu``'s ``maskformer_init(key(0))``
weights; each rank holds every phase to its own one-device run at the
reference's tolerances, and rank 0 saves that run.  Meanwhile the parent
runs ``sod_tpu``'s one-device two steps, its IoU@0.5 and its Evaluator on
the same numpy batches and the same images, written by the same function;
the port's one-device run is held to them at the same tolerances: loss and
IoU rtol 1e-4, parameters atol 1e-4 rtol 1e-3, the Evaluator's means rtol
1e-4 atol 1e-5.
"""
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from sod_tpu_torch import dryrun

PARAMS = dict(atol=1e-4, rtol=1e-3)
EVAL = dict(rtol=1e-4, atol=1e-5)


def _jax_mcfg():
    from sod_tpu.models.maskformer import MaskFormerConfig as JMC
    from sod_tpu.models.vit import ViTConfig as JViT

    return JMC(n_queries=4, n_decoder_layers=2,
               vit=JViT(patch_size=8, embed_dim=32, depth=2, n_heads=2, pos_grid=4))


def _jax_steps(params, n):
    """sod_tpu's one-device run of ``__graft_entry__.dryrun_multichip(n)``:
    two steps, and the IoU of the stepped weights on batch 0."""
    import jax
    import jax.numpy as jnp

    from sod_tpu.config import Config as JaxConfig
    from sod_tpu.models.maskformer import maskformer_apply
    from sod_tpu.train.optim import build_optimizer
    from sod_tpu.train.step import make_train_step
    from sod_tpu_torch.models.convert import state_dict_from_jax

    b = 2 * n
    cfg = JaxConfig(batch_size=b, compute_dtype="float32", use_pallas_attention=False,
                    max_gt_masks=2)
    mcfg = _jax_mcfg()
    tx = build_optimizer(cfg, n_iters_per_epoch=10)
    step = make_train_step(cfg, tx, mcfg)
    batches = [{k: jnp.asarray(v) for k, v in dryrun.make_batch(b, s).items()} for s in (0, 1)]
    p, o = params, tx.init(params)
    for bt in batches:
        p, o, m = step(p, o, bt)

    @jax.jit
    def eval_metric(p, image, gt):
        out = maskformer_apply(p, image, mcfg)
        pred = out["mask_pred"][:, -1] > 0.5
        g = jax.image.resize(gt[:, 0], (b,) + pred.shape[-2:], "nearest")
        g = (g > 0.5)[:, None]
        inter = (pred & g).sum((-1, -2)).astype(jnp.float32)
        union = (pred | g).sum((-1, -2)).astype(jnp.float32)
        return jnp.mean(jnp.max(inter / (union + 1e-7), axis=1))

    return {"loss": float(m["loss"]),
            "iou": float(eval_metric(p, batches[0]["image"], batches[0]["gt_masks"])),
            "state": state_dict_from_jax(jax.device_get(p))}


def _jax_eval(params, n, eval_root):
    """sod_tpu's one-device Evaluator of the initial weights on the images."""
    from sod_tpu.config import Config as JaxConfig
    from sod_tpu.train.evaluator import Evaluator as JaxEvaluator

    ecfg = JaxConfig(dir_dataset=eval_root, compute_dtype="float32",
                     use_pallas_attention=False, num_workers=2, max_gt_masks=2)
    return JaxEvaluator(params, ecfg, _jax_mcfg(), batch_size=2 * n)("duts")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from sod_tpu.models.maskformer import maskformer_init
    from sod_tpu_torch.models.convert import state_dict_from_jax

    tmp = tmp_path_factory.mktemp("dryrun")
    n = 8
    params = maskformer_init(jax.random.key(0), _jax_mcfg())
    sd = {k: np.array(v) for k, v in state_dict_from_jax(jax.device_get(params)).items()}
    saved = str(tmp / "rank0.pt")
    failed = []

    def ranks():
        try:
            dryrun.dryrun_multichip(n, device="cpu", state_dict=sd, save_to=saved)
        except BaseException as e:  # noqa: BLE001 - re-raised by the tests
            failed.append(e)

    threads = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"            # 8 ranks, one thread each
    try:
        t = threading.Thread(target=ranks)
        t.start()
        dryrun.write_eval_set(str(tmp / "ev"), 2 * n)
        with ThreadPoolExecutor(2) as pool:
            steps = pool.submit(_jax_steps, params, n)
            ev = pool.submit(_jax_eval, params, n, str(tmp / "ev"))
            ref = dict(steps.result(), eval=ev.result())
        t.join()
    finally:
        if threads is None:
            os.environ.pop("OMP_NUM_THREADS")
        else:
            os.environ["OMP_NUM_THREADS"] = threads
    return {"failed": failed, "ref": ref,
            "port": None if failed else torch.load(saved, weights_only=False)}


def test_every_phase_passes_on_8_ranks(runs):
    """Every rank passed every phase (1, 2, 2b, 3-7, 8, 8b, 9, 10) at the
    reference's tolerances; rank 0 printed the 12 lines."""
    assert not runs["failed"], runs["failed"]
    lines = runs["port"]["lines"]
    marks = ["eval_iou=", "grad-accum(2) loss=", "exact grad-accum(2)", "resume-then-continue",
             "sharded Evaluator", "tensor-parallel (4x2", "pipeline-parallel (4x2",
             "sequence-parallel (4x2", "FSDP/ZeRO (", "ZeRO-1 x TP (4x2", "3-D mesh (2x2x2",
             "seq x tensor mesh (2x2x2"]
    assert len(lines) == 12
    for line, mark in zip(lines, marks):
        assert line.startswith("sod_tpu_torch dryrun_multichip(8): ") and mark in line, line
        assert line.endswith(" ok"), line


def test_one_device_run_equals_sod_tpus(runs):
    """Rank 0's one-device two steps and IoU against sod_tpu's."""
    assert not runs["failed"], runs["failed"]
    got, want = runs["port"]["reference"], runs["ref"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
    np.testing.assert_allclose(got["iou"], want["iou"], rtol=1e-4)
    assert set(got["state"]) == set(want["state"])
    for k, w in want["state"].items():
        np.testing.assert_allclose(got["state"][k].numpy(), np.asarray(w), err_msg=k, **PARAMS)


def test_one_device_evaluator_equals_sod_tpus(runs):
    """Rank 0's one-device Evaluator on the 16 images against sod_tpu's: the
    14 means."""
    assert not runs["failed"], runs["failed"]
    got, want = runs["port"]["eval single"], runs["ref"]["eval"]
    assert set(got) == set(want) and len(want) == 14
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **EVAL)


@pytest.mark.parametrize("shape", [(3, 32, 32, 8, 8), (2, 37, 29, 8, 6), (1, 5, 7, 11, 3)])
def test_nearest_resize_is_jaxs(shape):
    """The IoU's GT resize samples where ``jax.image.resize(..., "nearest")``
    does, at down- and upsampling sizes."""
    import jax

    b, h, w, oh, ow = shape
    x = np.random.RandomState(0).rand(b, h, w).astype(np.float32)
    want = np.asarray(jax.image.resize(x, (b, oh, ow), "nearest"))
    got = dryrun.resize_nearest_half_pixel(torch.from_numpy(x), oh, ow).numpy()
    assert np.array_equal(got, want)


def test_gates_are_the_references():
    assert dryrun.gated(1) == ["1", "2", "2b", "3", "4", "8"]
    assert dryrun.gated(4) == ["1", "2", "2b", "3", "4", "5", "6", "7", "8", "8b"]
    assert dryrun.gated(6) == dryrun.gated(4)
    assert dryrun.gated(8) == list(dryrun.PHASES)


def test_cli_beyond_the_devices_raises_before_any_rendezvous():
    from sod_tpu_torch.parallel.mesh import device_limit

    with pytest.raises(ValueError, match=f"requested 9999 devices, have "
                                         f"{device_limit('cpu')}"):
        dryrun.main(["--n_devices", "9999", "--device", "cpu"])
    assert not dist.is_initialized()


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal without a card")
def test_cli_without_a_card_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun.main([])
    assert not dist.is_initialized()


def test_entry_shapes_equal_sod_tpus():
    """``entry(device="cpu")``'s forward on the CPU (K2's plain version)
    against the shapes of ``__graft_entry__.entry()``'s."""
    import jax

    import __graft_entry__

    fn, args = dryrun.entry(device="cpu")
    model, x = args
    assert model.cfg.vit.use_flash and tuple(x.shape) == (1, 224, 224, 3)
    assert x.dtype == torch.bfloat16 and not bool(x.any())
    got = fn(*args)
    jfn, jargs = __graft_entry__.entry()
    want = jax.eval_shape(jfn, *jargs)
    assert [tuple(t.shape) for t in got] == [tuple(s.shape) for s in want]
    assert all(bool(torch.isfinite(t.float()).all()) for t in got)
