"""End-to-end distributed subgraph counting (the paper's workload) on the
PyTorch/CUDA port.

Runs ``repro_torch.api.Counter`` with ``backend="distributed"`` on an R-MAT
graph split over ``--shards`` ranks, and compares the paper's three
exchange modes (naive all-to-all, pipelined adaptive-group at group
factors 1 and 3, the adaptive switch) and the relay ring.  Every mode
draws its colorings from the iteration keys, whatever the shard count, and
reports through the shared (eps, delta) estimator, so the modes print the
same statistics.  Each mode's samples are held against the single-device
backend's counts of the same colorings (within 1e-5 relative: the same
integers, summed in other orders).
What ``examples/count_distributed.py`` does on the JAX package's 8 host
devices.

On one card the ranks are ``LocalMesh`` thread ranks sharing it (the
"wire" is a device copy).  NCCL needs a card a rank: it cannot put two
ranks of one communicator on one GPU, so ranks over NCCL (``torchrun``
with ``python -m repro_torch.launch.count --mode ...``) wait for a machine
with one card a rank.

It runs on the card (the hand-written CUDA kernels) and raises without
one; ``--device cpu`` runs the kernels' plain versions instead.

Run:  PYTHONPATH=src python examples/torch_count_distributed.py [--template u5-2] \\
          [--shards 8] [--fuse] [--device cpu]
"""

from __future__ import annotations

import argparse
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch.api import Counter
from repro_torch.core import prng, relabel_random, rmat
from repro_torch.core.distributed import global_coloring
from repro_torch.core.estimator import call_key
from repro_torch.core.templates import template

#: the reference example's modes: (mode, group factor)
MODES = (("alltoall", 1), ("pipeline", 1), ("pipeline", 3), ("adaptive", 1), ("ring", 1))
#: each mode's samples against the single-device backend's, relative
RTOL = 1e-5


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--template", default="u5-2")
    ap.add_argument("--vertices", type=int, default=1 << 14)
    ap.add_argument("--edges", type=int, default=150_000)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--fuse", action="store_true",
                    help="fused SpMM->combine: no node's whole neighbor sum is held")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    g = relabel_random(rmat(args.vertices, args.edges, skew=3, seed=0), seed=1)
    tree = template(args.template)
    print(
        f"graph: {g.n} vertices, {g.num_edges} edges (skew {g.skewness():.0f}); "
        f"template {tree.name} (k={tree.n}); {args.shards} shards on {args.device}\n"
    )

    key = prng.key(0)
    base = Counter.from_graph(g, tree, backend="distributed", num_shards=args.shards,
                              mode="alltoall", fuse=args.fuse, device=args.device)
    # the single-device backend on the colorings the estimator draws below:
    # one call of args.iters iterations, each coloring drawn from its own key
    single = Counter.from_graph(g, tree, backend="single", fuse=args.fuse, device=args.device)
    keys = prng.split(call_key(key, 0), args.iters)
    want = np.asarray([single.count_coloring(global_coloring(k, g.n, base.plan.k, device="cpu"))
                       for k in keys]) * single.scale
    print(f"{'single':<14} {'':>8}      {len(want)} colorings   estimate ~ {want.mean():.4g}")

    out = {"single": want, "modes": {}}
    for mode, gf in MODES:
        # one plan build (edge bucketing) shared across all exchange modes
        counter = base.with_options(mode=mode, group_factor=gf)
        counter.sample_fn(key, args.iters)  # build and load outside the timer
        t0 = time.perf_counter()
        res = counter.estimate(n_iter=args.iters, key=key, batch=args.iters)
        dt = time.perf_counter() - t0
        label = f"{mode}(g={gf})" if mode == "pipeline" else mode
        rel = float(np.max(np.abs(res.samples - want) / np.maximum(np.abs(want), 1e-30)))
        print(
            f"{label:<14} {dt * 1e3:8.1f} ms / {res.niter} colorings   "
            f"estimate ~ {res.mean:.4g}   vs single {rel:.1e}"
        )
        if rel > RTOL:
            raise AssertionError(f"{label}: samples {res.samples} vs single {want} "
                                 f"({rel:.3g} > {RTOL})")
        out["modes"][label] = {"ms": dt * 1e3, "result": res, "rel": rel}
    return out


if __name__ == "__main__":
    main()
