"""Subgraph-counting launcher for the PyTorch port: one tree template, one device.

``python -m repro_torch.launch.count --config bench-small --mode single
[--fuse] --iters N --batch B --seed S [--device cuda|cpu]``

Synthesizes the configured R-MAT graph (or loads ``--graph``), plans the
config's template on the device (``cuda`` unless ``--device cpu``), warms
the kernels outside the timer, runs the median-of-means estimator and
prints the reference launcher's report lines.  The other backends and
features of ``repro.launch.count`` exit with an error naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..configs.subgraph import COUNTING_CONFIGS
from ..core.count_engine import build_counting_plan, plan_sample_fn
from ..core.estimator import call_seed, estimate_counts, num_groups_for
from ..core.graphs import load_edge_file, load_npz
from ..core.templates import template

_TODO = {
    "mode": "the distributed exchange modes are ROADMAP queue 1 item 7",
    "templates": "family counting is ROADMAP queue 1 item 3",
    "compact": "active-frontier compaction is ROADMAP queue 1 item 4",
    "checkpoint": "checkpoint and resume are ROADMAP queue 1 item 2",
}


def _report(label, shards, res, dt, ran):
    # the timer covers every coloring that actually executed (the last
    # batched call may overshoot --iters); the statistics use --iters
    print(f"mode={label} shards={shards}: {ran} colorings in {dt:.2f}s "
          f"({dt / max(ran, 1) * 1e3:.1f} ms/coloring)")
    groups = num_groups_for(res.delta, res.niter)
    print(f"estimate (median-of-means, {groups} groups): {res.estimate:.6g}")
    print(f"estimate (mean)           : {res.mean:.6g}  RSD {res.relative_sd:.2f}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.count")
    ap.add_argument("--config", default="bench-small", choices=sorted(COUNTING_CONFIGS))
    ap.add_argument("--graph", default=None, metavar="PATH",
                    help="real dataset (.npz from save_npz, else an edge-list "
                         "text file); default: synthesize the config's RMAT")
    ap.add_argument("--mode", default="single",
                    choices=["alltoall", "pipeline", "adaptive", "ring", "single"])
    ap.add_argument("--templates", default=None, metavar="A,B,C")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=8, help="colorings per backend call")
    ap.add_argument("--fuse", action="store_true",
                    help="fused SpMM->combine kernel: never holds the neighbor sum M")
    ap.add_argument("--spmm-kind", default="auto", choices=["auto", "edges", "blocks"])
    ap.add_argument("--compact", action="store_true")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR")
    ap.add_argument("--resume", default=None, metavar="DIR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.mode != "single":
        ap.error(f"--mode {args.mode}: {_TODO['mode']}; this port runs --mode single")
    if args.templates:
        ap.error(f"--templates: {_TODO['templates']}")
    if args.compact:
        ap.error(f"--compact: {_TODO['compact']}")
    if args.checkpoint_dir or args.resume:
        ap.error(f"--checkpoint-dir/--resume: {_TODO['checkpoint']}")
    if args.batch < 1:
        ap.error(f"--batch must be >= 1 (got {args.batch})")
    ccfg = COUNTING_CONFIGS[args.config]
    if ccfg.templates:
        ap.error(f"config {args.config} is a template family: {_TODO['templates']}")
    if ccfg.compact:
        ap.error(f"config {args.config} sets compact: {_TODO['compact']}")
    tree = template(ccfg.template)

    if args.graph:
        g = load_npz(args.graph) if args.graph.endswith(".npz") else load_edge_file(args.graph)
        print(f"loaded {g.name}: V={g.n} E={g.num_edges} skew={g.skewness():.0f}")
    else:
        print(f"synthesizing RMAT: V={ccfg.num_vertices} E={ccfg.num_edges} "
              f"skew={ccfg.skew}")
        g = ccfg.synthesize()
    plan = build_counting_plan(g, tree, spmm_kind=args.spmm_kind, fuse=args.fuse,
                               device=args.device)
    if plan.spmm_plan.patch_density is not None:
        print(f"spmm auto: {plan.spmm_plan.patch_density:.1f} edges/patch "
              f"-> kind={plan.spmm_plan.kind}")
    if plan.device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(plan.device)}")
    label = f"single(batch={args.batch},fuse={args.fuse},spmm={plan.spmm_plan.kind})"
    sample = plan_sample_fn(plan)
    sample(call_seed(args.seed, 0), args.batch)  # build and load kernels outside the timer
    ran = -(-args.iters // args.batch) * args.batch
    t0 = time.perf_counter()
    res = estimate_counts(sample, args.iters, args.seed, delta=args.delta, batch=args.batch)
    dt = time.perf_counter() - t0  # estimate_counts copied every result to the host
    _report(label, 1, res, dt, ran)
    return res


if __name__ == "__main__":
    main()
