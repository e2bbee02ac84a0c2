#!/usr/bin/env python3
"""Where the device time of a distributed count call goes, by kernel.

Runs the PyTorch port's distributed engine on one CUDA card: u10-2 on
``chip_smoke.py``'s cut of the bench-sparse row (R-MAT 2^22 vertices,
6,144,000 edges, skew 8), ``LocalMesh`` P = 4, B = 2, and for alltoall and
ring, unfused, one warm call then one call under ``torch.profiler`` at
float32 dense, float32 compact and int16 compact.  Prints, per call, the
host wall time, the device busy time, the rung the call ended on and the
kernels that took the most device time.

    python3 tools/torch_profile_exchange.py      # one card, about 2 minutes
"""

from __future__ import annotations

import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOP = 14  # kernels printed per call


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_exchange: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from repro_torch.comm import LocalMesh
    from repro_torch.configs.subgraph import COUNTING_CONFIGS
    from repro_torch.core import prng
    from repro_torch.core.distributed import (build_distributed_plan, global_coloring,
                                              make_count_fn, shard_coloring)
    from repro_torch.core.templates import template

    dev = torch.device("cuda", 0)
    print(chip_smoke.card_line(), flush=True)
    row = COUNTING_CONFIGS["bench-sparse"]
    g = chip_smoke.rmat_graph(*chip_smoke.SPARSE_GRAPHS["bench-sparse"], skew=row.skew)
    comp = build_distributed_plan(g, template(row.template), chip_smoke.COMPACT_SHARDS,
                                  device=dev, compact=True,
                                  density_threshold=row.density_threshold,
                                  capacity_factor=row.capacity_factor)
    dense = dataclasses.replace(comp, compaction=None)
    keys = prng.split(prng.key(13), chip_smoke.COMPACT_BATCH)
    col = torch.stack([global_coloring(k, g.n, comp.k, device=dev) for k in keys])
    cols = np.stack([shard_coloring(comp, c) for c in col.cpu().numpy()])
    mesh = LocalMesh(chip_smoke.COMPACT_SHARDS, device=dev)
    for mode in ("ring", "alltoall"):
        for tag, plan, wire in (("float32 dense", dense, "float32"),
                                ("float32 compact", comp, "float32"),
                                ("int16 compact", comp, "int16")):
            f = make_count_fn(plan, mesh, mode=mode, wire_dtype=wire)
            f(cols)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                f(cols)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            rows = []
            for ev in prof.key_averages():
                if ev.device_type != DeviceType.CUDA:
                    continue
                us = getattr(ev, "self_device_time_total", None)
                rows.append(((ev.self_cuda_time_total if us is None else us) / 1e3, ev.count,
                             ev.key[:90]))
            rows.sort(reverse=True)
            print(f"== {mode} {tag}: wall {wall:.1f} ms, device busy "
                  f"{sum(r[0] for r in rows):.1f} ms, ended on {f.rung}", flush=True)
            for ms, count, name in rows[:TOP]:
                print(f"   {ms:8.2f} ms  x{count:5d}  {name}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
