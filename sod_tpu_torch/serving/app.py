"""The SOD web app served by the port's model:
``python -m sod_tpu_torch.serving.app --port 5000``.

The routes, auth, quotas and payments are ``sod_tpu.serving.app``'s
(jax-free); only ``app.inference`` is the port's ``SelfMaskInference``.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> None:
    p = argparse.ArgumentParser("sod-tpu-torch serve")
    p.add_argument("--port", type=int, default=5000)
    p.add_argument("--model", type=str, default=None,
                   help="torch checkpoint in the reference's layout; "
                        "default: seeded random weights")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--allow-default-admin", action="store_true",
                   help="enable the reference's fixed admin credentials "
                        "(dev only; otherwise set SOD_ADMIN_PASSWORD)")
    args = p.parse_args(argv)

    from sod_tpu.config import Config, load_config
    from sod_tpu.serving.app import create_app
    from sod_tpu.serving.web import make_threaded_server
    from sod_tpu_torch.serving.inference import SelfMaskInference

    cfg = load_config(args.config) if args.config else Config()
    app = create_app(cfg=cfg, load_model=False,
                     allow_default_admin=args.allow_default_admin)
    app.inference = SelfMaskInference(model_path=args.model, cfg=cfg,
                                      device=args.device)
    print(f"serving on http://0.0.0.0:{args.port}", flush=True)
    make_threaded_server("0.0.0.0", args.port, app).serve_forever()


if __name__ == "__main__":
    main()
