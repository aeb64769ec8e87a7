"""Saliency inference service of the port (twin of
``sod_tpu/serving/inference.py``).

``SelfMaskInference`` holds the MaskFormer on an explicit device in the
compute dtype, and serves ``/predict``: resize to the model size -> uint8
upload -> on-device ImageNet normalize -> forward with the fused encoder
-> the last decoder layer's mask of the query with the highest objectness
-> LANCZOS back to the original size -> jet heatmap -> base64 PNGs; with
``refine``, the bilateral solver's refined and binary masks too
(``postprocess/bilateral_solver.py``, its solve on the service's device).
``MicroBatcher`` batches concurrent requests into one forward, enabled by
the ``micro_batch`` setting (``"auto"`` measures both policies at boot).
``Config.quantize = "int8"`` quantises the encoder blocks once at load and
the fused encoder then runs the W8A8 block (``ops/fused_block_int8``).

Imports torch, numpy and the stdlib; ``sod_tpu_torch.native`` and PIL are
imported where the host tail uses them.
"""
from __future__ import annotations

import base64
import io
import os
import queue
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sod_tpu_torch.data.augment import normalize_device
from sod_tpu_torch.models.convert import load_torch_state_dict, require_torch_checkpoint
from sod_tpu_torch.models.maskformer import MaskFormer, config_from, random_state_dict
from sod_tpu_torch.ops.fused_block_int8 import quantize_vit_blocks


def jet_colormap(x: np.ndarray) -> np.ndarray:
    """Classic jet colormap, [H, W] in [0,1] -> uint8 RGB."""
    x = np.clip(x, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4.0 * x - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4.0 * x - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4.0 * x - 1.0), 0, 1)
    return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


# jet over the 256 uint8 mask levels: indexing it with the uint8 mask is
# bit-identical to jet_colormap(mask / 255)
_JET_LUT = jet_colormap(np.arange(256, dtype=np.float32)[None] / 255.0)[0]

# "fast" (default): the native fixed-Huffman PNG encoder; "pil": zlib level 1
_PNG_MODE = os.environ.get("SOD_PNG_MODE", "fast")


def _b64_png(img) -> str:
    from PIL import Image

    if _PNG_MODE == "fast":
        from sod_tpu_torch import native

        arr = img if isinstance(img, np.ndarray) else np.asarray(img)
        if arr.dtype == np.uint8 and (arr.ndim == 2 or arr.shape[-1] == 3):
            png = native.png_encode(arr)
            if png is not None:
                return base64.b64encode(png).decode("ascii")
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    buf = io.BytesIO()
    img.save(buf, format="PNG", compress_level=1)
    return base64.b64encode(buf.getvalue()).decode("ascii")


class _Pending:
    __slots__ = ("arr", "event", "result", "error")

    def __init__(self, arr: np.ndarray):
        self.arr = arr
        self.event = threading.Event()
        # (device masks, device objectness, row): each caller copies its own
        # row back, so the dispatcher never waits on a download
        self.result: Optional[Tuple[torch.Tensor, torch.Tensor, int]] = None
        self.error: Optional[BaseException] = None


class MicroBatcher:
    """Bounded request-batching queue in front of the forward.

    Concurrent ``submit`` calls enqueue resized uint8 images; one
    dispatcher thread drains the queue, waits up to ``max_wait_ms`` for
    co-arriving requests (only when the batch already has peers or a
    dispatch is in flight), pads the group to the next bucket size and
    runs one batched forward on a small thread pool.  Padding rows are
    discarded; a lone request on an idle device dispatches at once."""

    def __init__(self, service, buckets: Tuple[int, ...] = (1, 4, 8, 16),
                 max_wait_ms: float = 3.0, dispatch_workers: int = 4):
        from concurrent.futures import ThreadPoolExecutor

        self._svc = service
        self.buckets = tuple(sorted(buckets))
        self.max_wait = max_wait_ms / 1e3
        self._q: "queue.Queue[Optional[_Pending]]" = queue.Queue()
        self._stop = threading.Event()
        self._pool = ThreadPoolExecutor(max_workers=max(1, dispatch_workers),
                                        thread_name_prefix="microbatch")
        self._in_flight = 0
        self._in_flight_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Blocking: (mask [H, W] f32, objectness [Q] f32) for one resized
        uint8 [H, W, 3] image."""
        if self._stop.is_set():
            raise RuntimeError("MicroBatcher is closed")
        p = _Pending(arr)
        self._q.put(p)
        # close() may have drained the queue between the check and the put
        if self._stop.is_set():
            self._fail_queued(RuntimeError("MicroBatcher closed"))
        p.event.wait()
        if p.error is not None:
            raise p.error
        masks, objs, row = p.result
        return masks[row].cpu().numpy(), objs[row].cpu().numpy()

    def close(self) -> None:
        self._stop.set()
        self._q.put(None)                           # wake the dispatcher
        self._thread.join(timeout=2.0)
        self._pool.shutdown(wait=False)
        self._fail_queued(RuntimeError("MicroBatcher closed"))

    def _fail_queued(self, err: BaseException) -> None:
        while True:
            try:
                p = self._q.get_nowait()
            except queue.Empty:
                return
            if p is not None:
                p.error = err
                p.event.set()

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _loop(self) -> None:
        max_b = self.buckets[-1]
        while not self._stop.is_set():
            first = self._q.get()
            if first is None:
                continue
            group: List[_Pending] = [first]
            while len(group) < max_b:                 # co-arrived requests
                try:
                    nxt = self._q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    break
                group.append(nxt)
            with self._in_flight_lock:
                busy = self._in_flight > 0
            if len(group) < max_b and (len(group) > 1 or busy):
                deadline = time.perf_counter() + self.max_wait
                while len(group) < max_b:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if nxt is None:
                        break
                    group.append(nxt)
            with self._in_flight_lock:
                self._in_flight += 1
            try:
                self._pool.submit(self._dispatch_group, group)
            except RuntimeError as e:                 # pool shut down mid-close
                with self._in_flight_lock:
                    self._in_flight -= 1
                for p in group:
                    p.error = e
                    p.event.set()
        self._fail_queued(RuntimeError("MicroBatcher closed"))

    def _dispatch_group(self, group: List[_Pending]) -> None:
        try:
            b = self._bucket(len(group))
            batch = np.zeros((b,) + group[0].arr.shape, group[0].arr.dtype)
            for i, p in enumerate(group):
                batch[i] = p.arr
            masks, objs = self._svc.forward_u8(batch)
            for i, p in enumerate(group):
                p.result = (masks, objs, i)
                p.event.set()
        except BaseException as e:  # noqa: BLE001 — surfaced to each caller
            for p in group:
                p.error = e
                p.event.set()
        finally:
            with self._in_flight_lock:
                self._in_flight -= 1


class PredictPipeline:
    """Host half of ``/predict``: decode -> resize to the model size ->
    ``model_step`` -> LANCZOS back to the original size -> jet heatmap
    blend -> base64 PNGs.  Subclasses provide ``cfg.eval_image_size`` and
    ``model_step``, and ``device`` where the refinement's solve runs."""

    def model_step(self, arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """uint8 [S, S, 3] -> (uint8 [S, S] mask, f32 [Q] objectness)."""
        raise NotImplementedError

    # where ``refine`` runs the bilateral solve: the pipeline's own device
    device = torch.device("cpu")

    def predict(self, image, refine: bool = False) -> Dict:
        """``refine`` also returns ``refined_mask`` (soft) and
        ``binary_mask`` PNGs: the bilateral solver on the original image,
        its solve on ``self.device``."""
        from PIL import Image

        from sod_tpu_torch import native

        if isinstance(image, bytes):
            image = Image.open(io.BytesIO(image))
        elif isinstance(image, io.BytesIO) or hasattr(image, "read"):
            image = Image.open(image)
        image = image.convert("RGB")
        orig_w, orig_h = image.size
        img_arr = np.asarray(image, np.uint8)

        size = self.cfg.eval_image_size
        # the native resampler is bit-identical to PIL's
        arr = native.resize_u8(img_arr, (size, size), "bilinear")
        if arr is None:
            arr = np.asarray(image.resize((size, size), Image.BILINEAR),
                             np.uint8)
        mask_small, obj = self.model_step(arr)

        mask_u8 = native.resize_u8(mask_small, (orig_h, orig_w), "lanczos")
        if mask_u8 is None:
            mask_u8 = np.asarray(Image.fromarray(mask_small).resize(
                (orig_w, orig_h), Image.LANCZOS))

        # LUT colormap + integer blend == (0.5 * img + 0.5 * heat) as uint8
        blended = native.jet_blend(img_arr, mask_u8, _JET_LUT)
        if blended is None:
            blended = ((img_arr.astype(np.uint16) + _JET_LUT[mask_u8]) >> 1
                       ).astype(np.uint8)
        out = {
            "original": _b64_png(img_arr),
            "mask": _b64_png(mask_u8),
            "heatmap": _b64_png(blended),
            "objectness_scores": [float(o) for o in obj],
        }
        if refine:
            from sod_tpu_torch.postprocess import bilateral_solver_output

            mask_arr = mask_u8.astype(np.float32) / 255.0
            soft, binary = bilateral_solver_output(image, mask_arr,
                                                   device=self.device)
            out["refined_mask"] = _b64_png(Image.fromarray(
                (np.clip(soft, 0, 1) * 255).astype(np.uint8)))
            out["binary_mask"] = _b64_png(Image.fromarray(
                (binary.astype(np.uint8) * 255)))
        return out


class SelfMaskInference(PredictPipeline):
    """The port's ``/predict`` model service.

    :param cfg: the experiment ``Config`` (``sod_tpu_torch.config``; any object
        with its fields).
    :param device: where the model runs ("cuda", "cuda:1", "cpu"); there
        is no default and no fallback.
    :param model_path: a torch checkpoint in the reference's layout
        (``.pt``/``.pth``/``.tar``, ``{'model': ...}`` accepted); None
        draws seeded random weights (``cfg.seed``).
    :param state_dict: weights given directly (e.g. ``state_dict_from_jax``
        output), instead of ``model_path``.
    """

    def __init__(self, *, cfg, device, model_path: Optional[str] = None,
                 state_dict: Optional[Dict] = None, warmup: bool = True):
        self.cfg = cfg
        if not cfg.use_binary_classifier:
            # sod_tpu's check and message (serving/inference.py:345-359)
            raise ValueError(
                "serving requires use_binary_classifier=True: the "
                "/predict path selects by objectness (ref app.py:267-277) "
                "and the non-bc forward carries no objectness head (ref "
                "maskformer.py:245-250 omits the key — the reference's "
                "own app would KeyError too).  Objectness-based "
                "evaluation of non-bc models is likewise unsupported, "
                "matching the reference (see docs/PARITY.md)")
        int8 = getattr(cfg, "quantize", "none") == "int8"
        if int8 and cfg.arch != "vit_small":
            raise ValueError(
                "quantize='int8' targets the ViT encoder's fused "
                "whole-block kernel (ops/fused_block_int8); the "
                "resnet50 arch has no quantized path")
        self.mcfg = config_from(cfg)
        self.device = torch.device(device)
        self._compute = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                         else torch.float32)

        model = MaskFormer(self.mcfg)
        if state_dict is None:
            state_dict = self._load_state_dict(model, model_path)
        state_dict = {k: torch.as_tensor(v) for k, v in state_dict.items()}
        model.load_state_dict(state_dict)
        # every float weight in the compute dtype, as sod_tpu casts its tree
        self.model = model.to(device=self.device, dtype=self._compute).eval()
        if int8:
            # from the weights as loaded, before the compute-dtype cast: the
            # int8 codes and f32 scales, biases and LayerNorm parameters must
            # not pass through bf16
            self.model.encoder.blocks_q = quantize_vit_blocks(
                state_dict, prefix="encoder.blocks.", device=self.device)

        self._batcher: Optional[MicroBatcher] = None
        mb = getattr(cfg, "micro_batch", False)
        buckets = tuple(sorted(getattr(cfg, "micro_batch_buckets", (1, 8))))
        if warmup:
            size = cfg.eval_image_size
            for b in (buckets if mb else (1,)):
                self.forward_u8(np.zeros((b, size, size, 3), np.uint8))
        if mb == "auto":
            use = self._probe_micro_batch(buckets) if warmup else False
        else:
            use = bool(mb)
        if use:
            self._batcher = MicroBatcher(
                self, buckets=buckets,
                max_wait_ms=getattr(cfg, "micro_batch_wait_ms", 3.0))

    def _load_state_dict(self, model: MaskFormer, model_path: Optional[str]):
        if model_path is None:
            return random_state_dict(model, self.cfg.seed)
        require_torch_checkpoint(model_path)
        return load_torch_state_dict(model_path)

    # ------------------------------------------------------------------
    def prep(self, u8: torch.Tensor) -> torch.Tensor:
        """uint8 [B, S, S, 3] on the device -> normalized compute dtype."""
        return normalize_device(u8).to(self._compute)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalized [B, S, S, 3] -> (f32 [B, S', S'] mask of the query
        with the highest last-layer objectness, f32 [B, Q] objectness)."""
        with torch.inference_mode():
            out = self.model(x, fused=True)
            obj = out["objectness"][:, -1, :, 0]
            best = torch.argmax(obj, dim=-1)
            sel = torch.take_along_dim(out["mask_pred"][:, -1],
                                       best[:, None, None, None], dim=1)[:, 0]
            return sel.float(), obj.float()

    def forward_u8(self, batch: np.ndarray):
        """Upload a uint8 [B, S, S, 3] host batch and run ``forward``."""
        u8 = torch.tensor(batch).to(self.device)
        return self.forward(self.prep(u8))

    def _probe_micro_batch(self, buckets, clients: int = 16,
                           per_client: int = 4, margin: float = 0.9) -> bool:
        """Drive both policies end to end (``clients`` threads each issuing
        ``per_client`` requests, once by direct B=1 dispatch and once
        through a real ``MicroBatcher``) and batch only when it is at
        least ``1/margin`` cheaper per image."""
        from concurrent.futures import ThreadPoolExecutor

        size = self.cfg.eval_image_size
        x = np.zeros((size, size, 3), np.uint8)     # host array: pays the upload

        def drive(submit) -> float:
            def worker(_i):
                for _ in range(per_client):
                    submit(x)
            with ThreadPoolExecutor(max_workers=clients) as pool:
                t0 = time.perf_counter()
                list(pool.map(worker, range(clients)))
                return (time.perf_counter() - t0) / (clients * per_client)

        def direct(arr):
            m, o = self.forward_u8(arr[None])
            m.cpu(), o.cpu()                        # copy back = sync

        single = drive(direct)
        mb = MicroBatcher(self, buckets=buckets,
                          max_wait_ms=getattr(self.cfg, "micro_batch_wait_ms",
                                              3.0))
        try:
            batched = drive(mb.submit)
        finally:
            mb.close()
        use = batched < single * margin
        print(f"[micro-batch probe] per-image cost, {clients} clients: "
              f"per-request {single * 1e3:.2f} ms, micro-batched "
              f"{batched * 1e3:.2f} ms "
              f"-> {'batched' if use else 'per-request'} dispatch",
              flush=True)
        return use

    @property
    def micro_batching(self) -> bool:
        return self._batcher is not None

    def close(self) -> None:
        """Stop the micro-batcher's threads, if any."""
        if self._batcher is not None:
            self._batcher.close()
            self._batcher = None

    # ------------------------------------------------------------------
    def model_step(self, arr: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        if self._batcher is not None:
            mask, obj = self._batcher.submit(arr)
        else:
            mask, obj = self.forward_u8(arr[None])
            mask, obj = mask[0].cpu().numpy(), obj[0].cpu().numpy()
        mask = np.clip(mask, 0.0, 1.0)
        return (mask * 255).astype(np.uint8), np.asarray(obj, np.float32)
