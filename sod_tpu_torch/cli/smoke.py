"""Installation smoke test of the port (twin of ``sod_tpu/cli/smoke.py``;
ref ``test_model.py``: imports check, the device, model build + forward).

The forward is the served one: weights in the config's compute dtype and
the fused encoder, so on the card it builds and launches the encoder's
kernel (K1; K8 under ``quantize: int8`` is left to the service).

``python -m sod_tpu_torch.cli.smoke [--config cfg.yaml] [--p_state_dict ckpt]
[--device cuda]``
"""
from __future__ import annotations

import argparse
import sys
import traceback


def main(argv=None) -> int:
    p = argparse.ArgumentParser("sod-tpu-torch smoke")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--p_state_dict", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to check and run the forward on")
    args = p.parse_args(argv)
    passed, failed = [], []

    def phase(name, fn):
        try:
            fn()
            passed.append(name)
            print(f"[PASS] {name}")
        except Exception as e:  # noqa: BLE001
            failed.append((name, e))
            print(f"[FAIL] {name}: {e}")
            traceback.print_exc()

    def _imports():
        import torch  # noqa: F401

        import sod_tpu_torch  # noqa: F401
        from sod_tpu_torch import data, losses, metrics, models, train  # noqa: F401

    phase("imports", _imports)

    def _device():
        import torch

        dev = torch.device(args.device)
        if dev.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(f"{args.device}: no CUDA device")
            print(f"       device: {dev} ({torch.cuda.get_device_name(dev)}), "
                  f"{torch.cuda.device_count()} visible")
        else:
            print(f"       device: {dev}")

    phase("device", _device)

    def _model():
        import torch

        from sod_tpu_torch.config import Config, load_config
        from sod_tpu_torch.models.maskformer import (
            MaskFormer,
            config_from,
            random_state_dict,
        )

        cfg = load_config(args.config) if args.config else Config()
        model = MaskFormer(config_from(cfg))
        if args.p_state_dict:
            from sod_tpu_torch.models.convert import (
                load_torch_state_dict,
                require_torch_checkpoint,
            )

            require_torch_checkpoint(args.p_state_dict)
            model.load_state_dict(load_torch_state_dict(args.p_state_dict))
            print(f"       weights: {args.p_state_dict}")
        else:
            model.load_state_dict(random_state_dict(model, 0))
        dev = torch.device(args.device)
        dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                 else torch.float32)
        model.to(device=dev, dtype=dtype).eval()
        with torch.inference_mode():
            out = model(torch.zeros((1, 224, 224, 3), device=dev, dtype=dtype),
                        fused=True)
        print(f"       mask_pred {tuple(out['mask_pred'].shape)} "
              f"objectness {tuple(out['objectness'].shape)} ({dtype})")

    phase("model build + forward", _model)

    print(f"\n{len(passed)} passed, {len(failed)} failed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
