#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the single-device tree-template
estimate on one NVIDIA card, end to end, with every kernel of that path
built from this checkout and held against its plain PyTorch version.

    python3 chip_smoke.py            # all phases, one card

Phases (each raises on failure; the exit code is 0 only if all pass):

1. build   — compile the three CUDA kernels with nvcc (sm_90a), in parallel;
2. kernels — each kernel against its plain version at the main path's shapes
             (every u12-2 node width on the full-width graph), exact (==) on
             integer tables whose sums stay below 2^24; timed beside the plain
             version, a library call where one exists, and its bound;
3. exact   — small graphs, templates u3-1/u5-2/u7-2, a fixed coloring: the
             port on the card, fused and unfused, == the brute-force oracle;
4. main    — the main path at full width: u12-2 on R-MAT 2^20 vertices / 10M
             edges (skew 3, relabeled), count_fn unfused and fused; maps of
             the two bitwise equal, launch counts as the plan predicts, one
             coloring through the plain versions on the card within rtol
             1e-5, fused peak memory below unfused;
5. launch  — the launcher (bench-small, --mode single) with and without
             --fuse prints identical estimates.

Then it prints the card's name and power limit, one JSON object with a
``kernels`` list (each kernel's launches on the main path, times beside
its plain version, a library call where one exists and its bound), and
as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
MAIN_BATCH = 4  # colorings per call on the main path (unfused peak about 33 GB)
MAIN_CALLS = 2  # batches per mode on the main path
PLAIN_RTOL = 1e-5  # float32 order: index_add_ uses atomics, counts exceed 2^24


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """``max |a - b|`` over row chunks, so no full-size temporary is made."""
    return max(((x - y).abs().max().item() for x, y in zip(a.split(1 << 16), b.split(1 << 16))),
               default=0.0)


def bound_ms(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def full_width_graph():
    from repro_torch.core.graphs import relabel_random, rmat

    t0 = time.perf_counter()
    g = relabel_random(rmat(2 ** 20, 10_000_000, skew=3, seed=0), seed=1)
    log(f"graph: R-MAT V={g.n} E_dir={g.num_directed} max_degree={g.max_degree} "
        f"synthesized in {time.perf_counter() - t0:.1f}s")
    return g


def node_shapes(plan):
    """Distinct (A, Bw, S, J) of the plan's internal nodes, with multiplicity."""
    shapes = {}
    for i, nd in plan.chain.internal_nodes():
        key = (plan.widths[nd.left], plan.widths[nd.right], plan.combine[i].s, plan.combine[i].j)
        if key not in shapes:
            shapes[key] = [0, plan.combine[i]]
        shapes[key][0] += 1
    return shapes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    times = _build.build(verbose=True)
    log(f"phase 1 build: {', '.join(f'{k} {v:.1f}s' for k, v in times.items())} "
        f"(wall {time.perf_counter() - t0:.1f}s)")


def phase_kernels(plan, batch: int):
    """Each kernel against its plain version at every node shape of ``plan``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.color_combine import color_combine
    from repro_torch.kernels.fused_count import fused_count
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    dev = plan.device
    sp = plan.spmm_plan
    n_pad, e = sp.n_pad, sp.num_directed
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)

    def table(width, hi):
        return torch.randint(0, hi, (n_pad, batch, width), generator=gen, device=dev).float()

    csr_bytes = (n_pad + 1) * 8 + e * 4
    csr = torch.sparse_csr_tensor(sp.indptr, sp.indices.long(),
                                  torch.ones(e, device=dev), (n_pad, n_pad))
    rows = {"spmm_edgetile": [], "color_combine": [], "fused_count": []}
    for (a, bw, s, j), (mult, tbl) in sorted(node_shapes(plan).items()):
        shape = f"A={a} B={bw} S={s} J={j} x{mult}"
        # Each check frees its outputs before the timings, so that at batch 4
        # and W = 792 (13 GB a table) no more than three tables are live.
        # The gather bound counts every edge's read of a B*W row segment once:
        # the bytes this design moves, beside the contract bound (each table
        # read once).
        gather_ms = e * batch * bw * 4 / HBM_BYTES_PER_S * 1e3
        # SpMM: sums of at most max_degree values <= 3 stay far below 2^24
        right = table(bw, 4)
        got = spmm_edge_tile(sp.indptr, sp.indices, right)
        want = ref.spmm_segment_ref(sp.indptr, sp.indices, right)
        err = max_abs_err(got, want)
        del want
        flat = right.reshape(n_pad, -1)
        lib_equal = torch.equal(torch.sparse.mm(csr, flat).reshape(got.shape), got)
        del got
        if err != 0 or not lib_equal:
            raise AssertionError(f"spmm_edgetile != plain at {shape}: max_abs_err {err}, "
                                 f"library equal {lib_equal}")
        nb, fl = 2 * n_pad * batch * bw * 4 + csr_bytes, e * batch * bw
        rows["spmm_edgetile"].append(dict(
            shape=shape, mult=mult, err=err,
            ms=cuda_ms(lambda: spmm_edge_tile(sp.indptr, sp.indices, right)),
            plain_ms=cuda_ms(lambda: ref.spmm_segment_ref(sp.indptr, sp.indices, right), 1),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, flat)),
            bound=bound_ms(nb, fl), gather_ms=gather_ms))
        del right, flat
        # combine: J * 3 * 3 <= 4455 per output
        left, m = table(a, 4), table(bw, 4)
        got = color_combine(left, m, tbl)
        want = ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2)
        err = max_abs_err(got, want)
        del got, want
        if err != 0:
            raise AssertionError(f"color_combine != plain at {shape}: max_abs_err {err}")
        nb = n_pad * batch * (a + bw + s) * 4 + tbl.pairs.numel() * 4
        rows["color_combine"].append(dict(
            shape=shape, mult=mult, err=err,
            ms=cuda_ms(lambda: color_combine(left, m, tbl)),
            plain_ms=cuda_ms(lambda: ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2), 1),
            library_ms=None, bound=bound_ms(nb, 2 * n_pad * batch * s * j), gather_ms=None))
        del left, m
        # fused: 0/1 tables, so J * max_degree stays below 2^24
        left, right = table(a, 2), table(bw, 2)
        got = fused_count(sp.indptr, sp.indices, left, right, tbl)
        want = ref.fused_count_ref(sp.indptr, sp.indices, left, right, tbl.idx1, tbl.idx2)
        err = max_abs_err(got, want)
        del got, want
        if err != 0:
            raise AssertionError(f"fused_count != plain at {shape}: max_abs_err {err}")
        nb = n_pad * batch * (a + bw + s) * 4 + csr_bytes + tbl.pairs.numel() * 4
        fl = e * batch * bw + 2 * n_pad * batch * s * j
        rows["fused_count"].append(dict(
            shape=shape, mult=mult, err=err,
            ms=cuda_ms(lambda: fused_count(sp.indptr, sp.indices, left, right, tbl)),
            plain_ms=cuda_ms(lambda: ref.fused_count_ref(
                sp.indptr, sp.indices, left, right, tbl.idx1, tbl.idx2), 1),
            library_ms=None, bound=bound_ms(nb, fl), gather_ms=gather_ms))
        del left, right
        log(f"phase 2 {shape}: " + "  ".join(
            f"{k} {v[-1]['ms']:.3f}ms (plain {v[-1]['plain_ms']:.1f}, bound "
            f"{v[-1]['bound'][0]:.3f} {v[-1]['bound'][1]})" for k, v in rows.items()))
        torch.cuda.empty_cache()
    return rows


def phase_exact(device):
    import numpy as np
    from repro_torch.core.brute_force import count_colorful_maps
    from repro_torch.core.count_engine import build_counting_plan, colorful_map_count
    from repro_torch.core.graphs import erdos_renyi, rmat
    from repro_torch.core.templates import template

    checked = 0
    for g in (erdos_renyi(40, 4.0, seed=2), rmat(64, 300, skew=3, seed=5)):
        for name in ("u3-1", "u5-2", "u7-2"):
            tree = template(name)
            coloring = np.random.default_rng(checked).integers(0, tree.n, g.n).astype(np.int32)
            want = count_colorful_maps(g, tree, coloring)
            for fuse in (False, True):
                plan = build_counting_plan(g, tree, fuse=fuse, device=device)
                got = float(colorful_map_count(plan, coloring))
                if got != want:
                    raise AssertionError(f"{g.name} {name} fuse={fuse}: {got} != brute force {want}")
            checked += 1
            log(f"phase 3 {g.name} {name}: {want} colorful maps, fused == unfused == brute force")


def phase_main(plan, batch: int, calls: int):
    """The main path at full width; returns the kernels' launch counts."""
    import torch
    from repro_torch.core.count_engine import count_fn, draw_colorings
    from repro_torch.core.table_program import leaf_table, root_count, run_table_program
    from repro_torch.kernels import ref
    from repro_torch.kernels.color_combine import color_combine
    from repro_torch.kernels.fused_count import fused_count
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    dev = plan.device
    n_internal = len(plan.chain.internal_nodes())
    results = {}
    spmm_edge_tile.launches = color_combine.launches = fused_count.launches = 0
    for fuse in (False, True):
        p = dataclasses.replace(plan, fuse=fuse)
        f = count_fn(p, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        maps = []
        t0 = time.perf_counter()
        for c in range(calls):
            gen = torch.Generator(device=dev)
            gen.manual_seed(c)
            m, est = f(gen)
            maps.append(m)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        maps = torch.cat(maps)
        if not torch.isfinite(maps).all() or maps.shape != (batch * calls,):
            raise AssertionError(f"fuse={fuse}: bad maps {maps}")
        peak = torch.cuda.max_memory_allocated(dev)
        results[fuse] = (maps, dt, peak)
        log(f"phase 4 fuse={fuse}: {batch * calls} colorings in {dt:.2f}s "
            f"({dt / (batch * calls) * 1e3:.1f} ms/coloring), peak "
            f"{peak / 2 ** 30:.2f} GiB, maps {maps.tolist()}")
    launches = {"spmm_edgetile": spmm_edge_tile.launches,
                "color_combine": color_combine.launches,
                "fused_count": fused_count.launches}
    want = n_internal * calls
    if launches != {"spmm_edgetile": want, "color_combine": want, "fused_count": want}:
        raise AssertionError(f"launch counts {launches}, plan predicts {want} each")
    if not torch.equal(results[False][0], results[True][0]):
        raise AssertionError("fused and unfused maps differ")
    if not results[True][2] < results[False][2]:
        raise AssertionError(f"fused peak {results[True][2]} not below unfused {results[False][2]}")
    # coloring 0 of call 0 through the plain versions on the card
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    colorings = draw_colorings(plan, batch, gen)[:1]
    sp = plan.spmm_plan

    def plain_node(i, tbl, c_left, c_right):
        m = ref.spmm_segment_ref(sp.indptr, sp.indices, c_right)
        return ref.color_combine_ref(c_left, m, tbl.idx1, tbl.idx2)

    (plain,) = run_table_program(plan.chain, plan.combine, leaf_table(colorings, plan.k, plan.n),
                                 plan.n, plain_node, root_fn=root_count)
    got = results[False][0][0].item()
    if not math.isclose(plain.item(), got, rel_tol=PLAIN_RTOL):
        raise AssertionError(f"kernels {got} vs plain versions {plain.item()} beyond rtol {PLAIN_RTOL}")
    log(f"phase 4: fused == unfused bitwise over {batch * calls} colorings; launches {launches}; "
        f"plain versions {plain.item()!r} vs kernels {got!r} "
        f"(rel {abs(plain.item() - got) / max(abs(got), 1):.2e}); "
        f"est/coloring {got * plan.scale:.6g}")
    per = {f: (dt / (batch * calls) * 1e3, peak) for f, (_, dt, peak) in results.items()}
    return launches, per


def phase_launch():
    from repro_torch.launch.count import main as count_main

    lines = {}
    for fuse in (False, True):
        argv = ["--config", "bench-small", "--mode", "single", "--iters", "8", "--batch", "4"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            count_main(argv + (["--fuse"] if fuse else []))
        out = buf.getvalue()
        log("".join(f"  {line}\n" for line in out.splitlines()).rstrip())
        lines[fuse] = [ln for ln in out.splitlines() if ln.startswith("estimate")]
    if not lines[False] or lines[False] != lines[True]:
        raise AssertionError(f"launcher estimates differ: {lines}")
    log("phase 5: launcher estimates identical with and without --fuse")


# ---------------------------------------------------------------------------


def kernels_line(rows, launches, per, card):
    meta = {
        "spmm_edgetile": ("src/repro_torch/kernels/csrc/spmm_edgetile.cu",
                          "src/repro/kernels/spmm_edgetile.py:137"),
        "color_combine": ("src/repro_torch/kernels/csrc/color_combine.cu",
                          "src/repro/kernels/color_combine.py:56"),
        "fused_count": ("src/repro_torch/kernels/csrc/fused_count.cu",
                        "src/repro/kernels/fused_count.py:105"),
    }
    out = []
    for name, shapes in rows.items():
        # one DP pass of u12-2 at the main batch: each node shape times its count
        tot = lambda key: sum(r[key] * r["mult"] for r in shapes)  # noqa: E731
        b_ms = sum(r["bound"][0] * r["mult"] for r in shapes)
        b_by = max(shapes, key=lambda r: r["bound"][0] * r["mult"])["bound"][1]
        src, rep = meta[name]
        lib = tot("library_ms") if shapes[0]["library_ms"] is not None else None
        out.append({
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": launches.get(name, 0), "max_abs_err": max(r["err"] for r in shapes),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "check": "exact (==)",
            "per_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms")}
                          | {"bound_ms": r["bound"][0], "gather_bound_ms": r["gather_ms"]}
                          for r in shapes],
        })
    main_path = {("fused" if fuse else "unfused"): {"ms_per_coloring": ms, "peak_bytes": peak}
                 for fuse, (ms, peak) in per.items()}
    return {"kernels": out, "card": card, "batch": MAIN_BATCH,
            "time_unit": "ms per u12-2 DP pass over all node shapes", "main_path": main_path}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.count_engine import build_counting_plan
    from repro_torch.core.templates import template

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    phase_build()
    g = full_width_graph()
    t0 = time.perf_counter()
    plan = build_counting_plan(g, template("u12-2"), device=dev)
    log(f"u12-2 plan on {dev}: n_pad={plan.n_pad} in {time.perf_counter() - t0:.1f}s")
    rows = phase_kernels(plan, MAIN_BATCH)
    phase_exact(dev)
    launches, per = phase_main(plan, MAIN_BATCH, MAIN_CALLS)
    del plan
    torch.cuda.empty_cache()
    phase_launch()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(kernels_line(rows, launches, per, card)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
