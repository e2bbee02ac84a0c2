"""Training launcher of the port: ``python -m repro_torch.launch.train --arch <id>``.

Trains the reduced config of an architecture row (``--full``: the published
one) with the fault-tolerant loop (``train.train``: checkpoint and resume,
the SIGTERM hook), on ``cuda`` unless ``--device cpu``, with the flags of
``repro.launch.train``.  ``--data D --model M`` runs ``D x M`` ranks as
threads on one device taking turns at host code
(``launch.mesh.make_local_mesh(..., turns=True)``) with
``ShardingConfig(batch_axes=("data",))``, as the reference does;
``--distributed`` joins the ``torchrun`` job this process was started in
(``launch.mesh.init_process_group``), one rank a process, laid out ``--data
x --model`` (``process_mesh``); every row runs on a mesh.
``--production-mesh`` is the reference's branch: the 16 x 16 ``(data,
model)`` mesh (``--multi-pod``: 2 x 16 x 16 ``(pod, data, model)``, the
batch over ``pod`` and ``data``) with ``ShardingConfig(batch_axes=...,
fsdp=params >= 2e9, seq_axis="model")``; with ``--distributed`` the
``torchrun`` world must have its 256 (512) ranks, else the mesh's thread
ranks take turns on ``--device`` (``launch.mesh.production_mesh``; the
shapes are ``launch.mesh.PRODUCTION_AXES``).  As in the reference,
``--multi-pod`` alone does nothing, and ``--production-mesh`` overrides
``--data`` and ``--model``.

Run::

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b --steps 3 \\
        --device cpu --ckpt-dir /tmp/ck --microbatches 2
    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --steps 3 \\
        --data 2 --model 2 [--device cpu]
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch smollm-360m --steps 3 --data 2 --model 2 --distributed --device cpu
    PYTHONPATH=src torchrun --nnodes 32 --nproc-per-node 8 ... -m repro_torch.launch.train \\
        --arch granite-3-8b --full --production-mesh --distributed
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from ..configs import get_arch
from ..configs.base import ShardingConfig
from ..models import build_model
from ..train import AdamWConfig, TrainConfig, train
from .mesh import init_process_group, make_local_mesh, process_mesh, production_mesh


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

    cfg = get_arch(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.production_mesh:
        mesh = production_mesh(multi_pod=args.multi_pod, distributed=args.distributed,
                               device=args.device)
        sharding = ShardingConfig(
            batch_axes=("pod", "data") if args.multi_pod else ("data",),
            fsdp=cfg.params_count() >= 2e9,
            seq_axis="model",
        )
    elif args.distributed:
        dev = init_process_group(args.device)
        mesh = process_mesh(data=args.data, iters=args.model, device=dev)
        sharding = ShardingConfig(batch_axes=("data",))
    elif args.data * args.model > 1:
        mesh = make_local_mesh(args.data, args.model, device=args.device, turns=True)
        sharding = ShardingConfig(batch_axes=("data",))
    else:
        mesh, sharding = None, None
    model = (build_model(cfg, device=args.device) if mesh is None
             else build_model(cfg, sharding, mesh))
    tcfg = TrainConfig(
        steps=args.steps,
        microbatches=args.microbatches,
        opt=AdamWConfig(total_steps=args.steps),
        checkpoint_dir=args.ckpt_dir,
    )
    return train(model, tcfg, mesh)


if __name__ == "__main__":
    main()
