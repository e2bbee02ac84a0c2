"""Training launcher of the port: ``python -m repro_torch.launch.train --arch <id>``.

Trains the reduced config of an architecture row (``--full``: the published
one) with the fault-tolerant loop (``train.train``: checkpoint and resume,
the SIGTERM hook), on ``cuda`` unless ``--device cpu``, with the flags of
``repro.launch.train``.  The mesh flags (``--production-mesh``,
``--multi-pod``, ``--data``/``--model`` above 1, ``--distributed``) wait for
the sharding specs (ROADMAP queue 1 item 17) and exit with that error.

Run::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 3 \\
        --device cpu --ckpt-dir /tmp/ck --microbatches 2
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..configs import get_arch
from ..models import build_model
from ..train import AdamWConfig, TrainConfig, train


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--full", action="store_true", help="published config")
    ap.add_argument("--production-mesh", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--data", type=int, default=1, help="local mesh data axis")
    ap.add_argument("--model", type=int, default=1, help="local mesh model axis")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--distributed", action="store_true",
                    help="one process a rank of a torch.distributed job")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    meshed = [f for f, on in (("--production-mesh", args.production_mesh),
                              ("--multi-pod", args.multi_pod),
                              ("--data/--model > 1", args.data * args.model > 1),
                              ("--distributed", args.distributed)) if on]
    if meshed:
        raise NotImplementedError(f"{', '.join(meshed)}: training on a mesh waits for the "
                                  f"sharding specs (ROADMAP queue 1 item 17)")
    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    tcfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        opt=AdamWConfig(total_steps=args.steps),
        checkpoint_dir=args.ckpt_dir,
    )
    return train(model, tcfg)


if __name__ == "__main__":
    main()
