"""End-to-end LM training driver with checkpoint and restart, on the
PyTorch/CUDA port.

Trains an architecture row for a few hundred steps on the synthetic token
stream, checkpointing periodically; re-running resumes from the latest
checkpoint and goes on as an uninterrupted run would, bit for bit.  The
reduced config by default; ``--full`` for the published one, and
``--arch`` for any of the 10 rows.  What ``examples/train_lm.py`` does on
the JAX package: the same stream, schedule and AdamW, step by step through
``repro_torch.train.make_train_step`` (``python -m repro_torch.launch.train``
is the driver with preemption and meshes).

It runs on the card and raises without one; ``--device cpu`` trains on the
CPU.  Training attends through plain-torch ``chunked_attention``, as the
reference trains through its XLA path, so no hand-written kernel runs.

Run:  PYTHONPATH=src python examples/torch_train_lm.py --arch smollm-360m --steps 300 \\
          [--ckpt-dir DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional, Sequence

import torch

from repro_torch.configs import get_arch
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, CheckpointManager, TrainConfig
from repro_torch.train.data import DataConfig, synthetic_batch
from repro_torch.train.optimizer import init_opt_state
from repro_torch.train.train_loop import make_train_step


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true", help="published config")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    model = build_model(cfg, device=args.device)
    print(
        f"arch {cfg.name}: {cfg.params_count() / 1e6:.1f}M params "
        f"({cfg.active_params_count() / 1e6:.1f}M active) on {model.device}"
    )

    tcfg = TrainConfig(
        steps=args.steps,
        opt=AdamWConfig(lr_peak=1e-3, warmup_steps=20, total_steps=args.steps),
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.checkpoint_every,
        log_every=args.log_every,
    )
    dcfg = DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch, seq_len=args.seq)

    step, _ = make_train_step(model, tcfg)
    params = model.init_fn(torch.Generator(device=model.device).manual_seed(0))
    params.requires_grad_(True)
    weights = dict(params.named_parameters())
    opt = init_opt_state(weights)
    ckpt = CheckpointManager(args.ckpt_dir)
    start = ckpt.latest_step() or 0
    if start:
        restored = ckpt.restore(start, {"params": weights, "opt": opt})
        with torch.no_grad():
            torch._foreach_copy_(list(weights.values()),
                                 [restored["params"][k] for k in weights])
        opt = restored["opt"]
        print(f"resumed from checkpoint at step {start}")

    losses = {}
    for i in range(start, args.steps):
        batch = synthetic_batch(dcfg, i, model.device)
        params, opt, metrics = step(params, opt, batch)
        losses[i + 1] = float(metrics["loss"])
        if (i + 1) % tcfg.log_every == 0:
            print(f"step {i + 1:4d}  loss {losses[i + 1]:.4f}  lr {float(metrics['lr']):.2e}")
        if (i + 1) % tcfg.checkpoint_every == 0:
            ckpt.save(i + 1, {"params": dict(params.named_parameters()), "opt": opt})
    ckpt.wait()
    if losses:
        print(f"\nloss: {losses[start + 1]:.4f} -> {losses[args.steps]:.4f} "
              f"over {args.steps - start} steps")
    return {"start": start, "losses": losses, "params": params, "opt": opt}


if __name__ == "__main__":
    main()
