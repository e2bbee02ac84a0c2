"""Subgraph-counting launcher for the PyTorch port.

``python -m repro_torch.launch.count --config bench-small --mode single
[--templates A,B,C] [--fuse] [--spmm-kind auto|edges|blocks] [--compact
--density-threshold T --capacity-factor F --probes P] --iters N --batch B
--seed S [--checkpoint-dir DIR | --resume DIR] [--device cuda|cpu]``

``--mode alltoall|pipeline|adaptive|ring [--group-factor G] [--adaptive
model|measured] [--shards P] [--wire-dtype float32|int16|int8]`` runs the
distributed exchange engine instead: a ``LocalMesh`` of P thread ranks on
the device, or, started by ``torchrun`` (``WORLD_SIZE`` > 1), one rank a
process over the world (NCCL on ``cuda``, gloo with ``--device cpu``), and
prints the compaction report, then the per-node routes and their modeled
costs (``routing: wire=...``) before the estimate.  Its colorings are drawn
from the iteration keys whatever the shard count, so ``--shards 2`` and
``--shards 4`` print identical estimates; ``--compact`` compacts the
exchange and ``--wire-dtype`` narrows it, and neither changes a bit of the
estimates.

Synthesizes the configured R-MAT graph (or loads ``--graph``), resolves the
config row into a ``CountRequest`` and runs it through the ``Counter``
facade as ``repro.launch.count`` does: the plan lives on the device
(``cuda`` unless ``--device cpu``), the kernels are warmed outside the
timer, and ``--seed S`` keys the run with ``prng.key(S)``, so the port
draws the reference launcher's colorings.  ``--checkpoint-dir`` persists
the estimator state; ``--resume`` continues a killed run bit for bit.
``--templates`` (or a config row with a ``templates`` family, such as
``bench-family``, ``bench-cycles`` or ``bench-tw2-mixed``) counts the whole
family, trees and treewidth-2 names alike, in one shared-DAG pass per batch
(``Counter.estimate_many``).  ``--compact`` (or a config row that sets
``compact``, such as ``bench-sparse``) runs the active-frontier compacted
plan and prints the probed node densities and engaged capacities; its
estimates equal the dense run's (``--density-threshold -1`` engages no
node).
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from ..api import Counter
from ..configs.subgraph import COUNTING_CONFIGS
from ..core import prng
from ..core.estimator import num_groups_for
from ..core.graphs import load_edge_file, load_npz
from ..core.templates import TEMPLATES

def _plan_report(plan):
    """The density signals the plan's choices used (the reference's report):
    the spmm auto patch density of a single-device plan, and the per-node
    table densities and engaged capacities of active-frontier compaction."""
    spmm = getattr(plan, "spmm_plan", None)
    if spmm is not None and spmm.patch_density is not None:
        print(f"spmm auto: {spmm.patch_density:.1f} edges/patch -> kind={spmm.kind}")
    spec = plan.compaction
    if spec is None:
        return
    dens = " ".join(f"n{i}={spec.density[i]:.3f}" for i in sorted(spec.density))
    caps = {}
    for tag, m in (("combine", spec.combine_caps), ("table", spec.table_caps),
                   ("exchange", spec.exchange_caps), ("ring", spec.shard_caps)):
        for i, c in sorted(m.items()):
            caps[f"{tag}[{i}]"] = c
    print(f"compaction: threshold {spec.threshold} node densities: {dens}")
    print(f"compaction caps: {caps if caps else 'none engaged'}")


def _route_report(counter, request):
    """The exchange routes of each node and the cost model behind them
    (calibrated under ``--adaptive measured``)."""
    from ..core.distributed import plan_route_report

    opts = request.plan_opts
    rep = plan_route_report(counter.plan, mode=opts.get("mode", "adaptive"),
                            group_factor=opts.get("group_factor", 1),
                            wire_dtype=opts.get("wire_dtype", "float32"),
                            adaptive=opts.get("adaptive", "model"), mesh=counter.mesh)
    m = rep["model"]
    src = "calibrated" if rep["calibrated"] else "assumed"
    print(f"routing: wire={rep['wire_dtype']} {src} model alpha={m['alpha']:.3g}s "
          f"beta={m['beta']:.3g}s/B flops={m['flops_per_s']:.3g}/s")
    for i, row in sorted(rep["per_node"].items()):
        print(f"  node {i}: {row['mode']:<8} a2a {row['a2a_bytes'] / 1e6:.3f} MB "
              f"ring {row['ring_bytes'] / 1e6:.3f} MB predicted {row['predicted_s'] * 1e6:.1f} us")


def _robust_report(res):
    """Recovery provenance: what was restored, what was given up on."""
    if res.resumed_from:
        print(f"resumed: {res.resumed_from} colorings restored from "
              f"checkpoint (progress/RSD include them)")
    for q in res.quarantined:
        print(f"quarantined: {q}")


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
    ap.add_argument("--templates", default=None, metavar="A,B,C",
                    help="comma-separated template family (trees and treewidth-2 names "
                         "like cycle5,diamond): count them all in one pass over the shared "
                         "sub-template DAG (Counter.estimate_many); default: the config's "
                         "family, else its single template")
    ap.add_argument("--iters", type=int, default=16)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--batch", type=int, default=8, help="colorings per backend call")
    ap.add_argument("--fuse", action="store_true",
                    help="fused SpMM->combine kernel: never holds the neighbor sum M")
    ap.add_argument("--spmm-kind", default="auto", choices=["auto", "edges", "blocks"])
    ap.add_argument("--compact", action="store_true", default=None,
                    help="active-frontier compaction: probe per-node table densities and "
                         "compact the nodes at or below --density-threshold")
    ap.add_argument("--density-threshold", type=float, default=None,
                    help="compact a node once its active-row fraction is at or below this "
                         "(default: the config row's)")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="capacity headroom over the probed active maximum before the dense "
                         "overflow fallback (default: the config row's)")
    ap.add_argument("--probes", type=int, default=None,
                    help="probe colorings the densities are measured on (default 2)")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="persist estimator state (atomic, checksummed) under DIR "
                         "every --checkpoint-every colorings")
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="resume from the latest readable checkpoint in DIR (implies "
                         "--checkpoint-dir DIR); bit-exact vs an uninterrupted run")
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="checkpoint cadence in colorings (default: every batch when a "
                         "checkpoint dir is set)")
    ap.add_argument("--max-retries", type=int, default=None,
                    help="retry transient per-batch faults up to N times, then "
                         "quarantine the batch and report it")
    ap.add_argument("--target-rsd", type=float, default=None,
                    help="stop early once the running relative standard error of the "
                         "mean reaches this (resume-aware)")
    ap.add_argument("--wire-dtype", default=None, choices=["float32", "int16", "int8"],
                    help="distributed modes: ship the exchange payloads at this width; a "
                         "saturated batch re-runs one rung wider, so estimates are exact "
                         "(default: the config row's)")
    ap.add_argument("--group-factor", type=int, default=1,
                    help="distributed pipeline: shifts a step (W = ceil((P-1)/G) steps)")
    ap.add_argument("--adaptive", default=None, choices=["model", "measured"],
                    help="the adaptive router's cost model: the assumed link constants, or "
                         "one calibration probe on the mesh")
    ap.add_argument("--shards", type=int, default=None,
                    help="distributed modes: graph shards, a LocalMesh of that many thread "
                         "ranks on the device (default: the config row's; under torchrun the "
                         "world size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error(f"--batch must be >= 1 (got {args.batch})")
    ccfg = COUNTING_CONFIGS[args.config]
    single = args.mode == "single"
    family = list(ccfg.templates)
    if args.templates:
        # fail fast, before any graph is synthesized or plan built: unknown
        # or duplicate names are a typo, not a workload
        family = [s.strip() for s in args.templates.split(",") if s.strip()]
        unknown = [s for s in family if s not in TEMPLATES]
        if unknown:
            ap.error(f"unknown template(s) {', '.join(sorted(set(unknown)))}; "
                     f"registry has: {', '.join(sorted(TEMPLATES))}")
        dups = sorted({s for s in family if family.count(s) > 1})
        if dups:
            ap.error(f"duplicate template(s) in --templates: {', '.join(dups)}")
        if not family:
            ap.error("--templates is empty after parsing")
    ckpt_dir = args.resume or args.checkpoint_dir
    robust_kw = dict(
        checkpoint=ckpt_dir,
        checkpoint_every=args.checkpoint_every or (args.batch if ckpt_dir else 0),
        resume=bool(args.resume),
        max_retries=args.max_retries,
        target_rsd=args.target_rsd,
    )

    if args.graph:
        g = load_npz(args.graph) if args.graph.endswith(".npz") else load_edge_file(args.graph)
        print(f"loaded {g.name}: V={g.n} E={g.num_edges} skew={g.skewness():.0f}")
    else:
        print(f"synthesizing RMAT: V={ccfg.num_vertices} E={ccfg.num_edges} "
              f"skew={ccfg.skew}")
        g = ccfg.synthesize()
    # the fused kernel walks the CSR and a block plan has no edge layout to
    # fuse over: when fusing, steer 'auto' to 'edges' (as the reference does)
    spmm_kind = "edges" if args.fuse and args.spmm_kind == "auto" else args.spmm_kind
    overrides = {name: val for name, val in (("compact", args.compact),
                                             ("density_threshold", args.density_threshold),
                                             ("capacity_factor", args.capacity_factor),
                                             ("probes", args.probes)) if val is not None}
    if single:
        request = ccfg.to_request(g, backend="single", n_iter=args.iters, delta=args.delta,
                                  batch=args.batch, spmm_kind=spmm_kind, fuse=args.fuse,
                                  device=args.device, **overrides)
    else:
        dist_opts = _mesh_opts(args, ccfg)
        for name, val in (("adaptive", args.adaptive), ("wire_dtype", args.wire_dtype)):
            if val is not None:
                dist_opts[name] = val
        request = ccfg.to_request(g, backend="distributed", n_iter=args.iters,
                                  delta=args.delta, batch=args.batch, mode=args.mode,
                                  group_factor=args.group_factor, fuse=args.fuse,
                                  **dist_opts, **overrides)
    counter = Counter.from_request(request)
    key = prng.key(args.seed)
    ran = -(-args.iters // args.batch) * args.batch
    if family:
        return _run_family(counter, request, family, key, ran, robust_kw, args)
    if not single:
        return _run_distributed(counter, request, key, ran, robust_kw, args)
    plan = counter.plan
    _plan_report(plan)
    if plan.device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(plan.device)}")
    # report whether fusion really engaged: it needs the edge layout
    fused = args.fuse and plan.spmm_plan.kind == "edges"
    label = f"single(batch={args.batch},fuse={fused},spmm={plan.spmm_plan.kind})"
    counter.sample_fn(key, args.batch)  # build and load kernels outside the timer
    t0 = time.perf_counter()
    res = counter.estimate(n_iter=request.n_iter, delta=request.delta, key=key,
                           batch=request.batch, **robust_kw)
    dt = time.perf_counter() - t0  # the estimator copied every result to the host
    _robust_report(res)
    _report(label, 1, res, dt, ran)
    return res


def _mesh_opts(args, ccfg) -> dict:
    """The distributed backend's mesh: the torchrun world, or a LocalMesh of
    ``--shards`` ranks (default the config row's) on the device."""
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        from .mesh import init_process_group, process_mesh

        dev = init_process_group(args.device)
        mesh = process_mesh(device=dev)
        return {"mesh": mesh, "num_shards": mesh.data_size, "device": dev}
    return {"num_shards": args.shards or ccfg.num_shards, "device": args.device}


def _run_distributed(counter, request, key, ran, robust_kw, args):
    plan = counter.plan
    mesh = counter.mesh
    _plan_report(plan)
    _route_report(counter, request)
    if mesh.device.type == "cuda":
        print(f"device: {torch.cuda.get_device_name(mesh.device)}")
    label = (f"{request.plan_opts['mode']}(batch={args.batch},fuse={args.fuse},"
             f"g={args.group_factor},mesh={mesh.data_size}x{mesh.iter_size})")
    counter.sample_fn(key, args.batch)  # build and load kernels outside the timer
    t0 = time.perf_counter()
    res = counter.estimate(n_iter=request.n_iter, delta=request.delta, key=key,
                           batch=request.batch, **robust_kw)
    dt = time.perf_counter() - t0
    _robust_report(res)
    _report(label, plan.num_shards, res, dt, ran)
    return res


def _run_family(counter, request, family, key, ran, robust_kw, args):
    """One shared-DAG pass per batch counts the whole family; the
    single-template plan is never built."""
    # build the plan and load the kernels at the real batch, outside the timer
    counter.estimate_many(family, n_iter=request.batch, key=key, batch=request.batch)
    t0 = time.perf_counter()
    res = counter.estimate_many(family, n_iter=request.n_iter, delta=request.delta, key=key,
                                batch=request.batch, **robust_kw)
    dt = time.perf_counter() - t0
    _robust_report(res)
    shards = 1 if args.mode == "single" else counter.mesh.data_size
    print(f"mode={args.mode}(batch={args.batch},fuse={args.fuse}) shards={shards}: family of {len(res)} "
          f"templates, k={res.k}, {res.unique_tables} unique tables (vs {res.chain_tables} "
          f"chain nodes), {ran} colorings in {dt:.2f}s ({dt / max(ran, 1) * 1e3:.1f} "
          f"ms/coloring)")
    groups = num_groups_for(res.delta, res.niter)
    for one in res:
        print(f"  {one.template:>10}: median-of-means {one.estimate:.6g} ({groups} groups)  "
              f"mean {one.mean:.6g} RSD {one.relative_sd:.2f}")
    return res


if __name__ == "__main__":
    main()
