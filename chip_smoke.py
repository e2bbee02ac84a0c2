#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: the single-device tree-template
estimate on one NVIDIA card, end to end, with every kernel of its paths
built from this checkout and held against its plain PyTorch version.

    python3 chip_smoke.py            # all phases, one card (about 4 minutes)

Phases (each raises on failure; the exit code is 0 only if all pass):

1. build   — compile the four CUDA kernels with nvcc (sm_90a), in parallel;
2. kernels — each kernel against its plain version at its path's shapes
             (every u12-2 node width), exact (==) on integer tables whose
             sums stay below 2^24; timed beside the plain version, a library
             call where one exists, and its bound.  The edge SpMM, combine
             and fused kernels run on the main cell's graph; the block SpMM
             on the dense cell's, where it is held == the plain edge-list
             sum and == spmm_edgetile on the whole graph, and == its own
             dense-patch plain version on a sample of row blocks;
3. exact   — small graphs, templates u3-1/u5-2/u7-2, a fixed coloring: the
             port on the card, edge and block plans, fused and unfused, ==
             the brute-force oracle;
4. main    — the main path at full width: u12-2 on R-MAT 2^20 vertices / 10M
             edges (skew 3, relabeled), count_fn unfused and fused; maps of
             the two bitwise equal, launch counts as the plan predicts, one
             coloring through the plain versions on the card within rtol
             1e-5, fused peak memory below unfused;
5. dense   — Counter.estimate on the dense cell: u12-2 on R-MAT 2^16 / 16M
             (average degree 449), spmm_kind="auto" plans the block format;
             its per-coloring samples == those of spmm_kind="edges" for the
             same key, bitwise; launch counts as the plan predicts; one
             coloring through the plain versions within rtol 1e-5;
6. launch  — the launcher: bench-small with and without --fuse prints
             identical estimates; --checkpoint-dir then --resume prints the
             same estimate; --fuse --spmm-kind auto on a dense --graph file
             reports kind=edges and fuse=True.

Then it prints the card's name and power limit, one JSON object with a
``kernels`` list (each kernel's launches on the paths it runs, times
beside its plain version, a library call where one exists and its bound),
and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (data sheet)
FP32_FLOPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, an FMA as 2 (data sheet)
FP32_ADDS_PER_S = FP32_FLOPS_PER_S / 2  # a lone add issues at the FMA rate
MAIN_BATCH = 4  # colorings per call on the main path (unfused peak about 33 GB)
MAIN_CALLS = 2  # batches per mode on the main path
DENSE_BATCH = 16  # colorings per call on the dense cell (widest table 3.33 GB)
DENSE_ITERS = 32  # colorings per estimate on the dense cell: 2 calls
DENSE_PLAIN_BLOCKS = 8  # row blocks the dense-product plain block SpMM is held on
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


def bound_ms(nbytes: float, adds: float, fmas: float = 0):
    """The larger of the bytes' time at the HBM rate and the float32 adds'
    and FMAs' time at the data sheet's rate (either issues once a cycle)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (adds + fmas) / FP32_ADDS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rmat_graph(n: int, m: int):
    """``relabel_random(rmat(n, m, skew=3, seed=0), seed=1)``, timed."""
    from repro_torch.core.graphs import relabel_random, rmat

    t0 = time.perf_counter()
    g = relabel_random(rmat(n, m, skew=3, seed=0), seed=1)
    log(f"graph: R-MAT V={g.n} E_dir={g.num_directed} max_degree={g.max_degree} "
        f"avg_degree={g.avg_degree:.1f} synthesized in {time.perf_counter() - t0:.1f}s")
    return g


def reset_launches():
    from repro_torch.kernels import color_combine, fused_count, spmm_block, spmm_edgetile

    for fn in (spmm_edgetile.spmm_edge_tile, spmm_block.spmm_block,
               color_combine.color_combine, fused_count.fused_count):
        fn.launches = 0


def read_launches():
    from repro_torch.kernels import color_combine, fused_count, spmm_block, spmm_edgetile

    return {"spmm_edgetile": spmm_edgetile.spmm_edge_tile.launches,
            "spmm_block": spmm_block.spmm_block.launches,
            "color_combine": color_combine.color_combine.launches,
            "fused_count": fused_count.fused_count.launches}


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
        nb = 2 * n_pad * batch * bw * 4 + csr_bytes
        rows["spmm_edgetile"].append(dict(
            shape=shape, mult=mult, err=err,
            ms=cuda_ms(lambda: spmm_edge_tile(sp.indptr, sp.indices, right)),
            plain_ms=cuda_ms(lambda: ref.spmm_segment_ref(sp.indptr, sp.indices, right), 1),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, flat)),
            bound=bound_ms(nb, e * batch * bw), gather_ms=gather_ms))
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
            library_ms=None, bound=bound_ms(nb, 0, n_pad * batch * s * j), gather_ms=None))
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
        rows["fused_count"].append(dict(
            shape=shape, mult=mult, err=err,
            ms=cuda_ms(lambda: fused_count(sp.indptr, sp.indices, left, right, tbl)),
            plain_ms=cuda_ms(lambda: ref.fused_count_ref(
                sp.indptr, sp.indices, left, right, tbl.idx1, tbl.idx2), 1),
            library_ms=None, bound=bound_ms(nb, e * batch * bw, n_pad * batch * s * j),
            gather_ms=gather_ms))
        del left, right
        log(f"phase 2 {shape}: " + "  ".join(
            f"{k} {v[-1]['ms']:.3f}ms (plain {v[-1]['plain_ms']:.1f}, bound "
            f"{v[-1]['bound'][0]:.3f} {v[-1]['bound'][1]})" for k, v in rows.items()))
        torch.cuda.empty_cache()
    return rows


def row_block_sample(sp, count: int):
    """The patch CSR restricted to ``count`` row blocks spread over the graph
    (first and last included): the other row blocks keep no patch."""
    import torch

    nrb = sp.patch_ptr.numel() - 1
    keep = torch.linspace(0, nrb - 1, count, device=sp.patch_ptr.device).round().long().unique()
    counts = torch.diff(sp.patch_ptr.long())
    sel = torch.zeros(nrb, dtype=torch.bool, device=keep.device)
    sel[keep] = True
    ptr = torch.zeros(nrb + 1, dtype=torch.long, device=keep.device)
    ptr[1:] = torch.cumsum(torch.where(sel, counts, 0), 0)
    patches = torch.cat([torch.arange(int(sp.patch_ptr[r]), int(sp.patch_ptr[r + 1]),
                                      device=keep.device) for r in keep.tolist()])
    rows = (keep[:, None] * 128 + torch.arange(128, device=keep.device)).reshape(-1)
    return (ptr.int(), sp.patch_col[patches].contiguous(), sp.patch_bits[patches].contiguous(),
            rows, len(keep))


def used_source_rows(sp) -> int:
    """Source rows the block kernel stages, summed over patches: the
    popcount of each patch's column union."""
    import torch

    union = torch.zeros_like(sp.patch_bits[:, 0, :]).long()
    for r in range(sp.patch_bits.shape[1]):
        union |= sp.patch_bits[:, r, :].long() & 0xFFFFFFFF
    x = union - ((union >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return int((((x * 0x01010101) & 0xFFFFFFFF) >> 24).sum())


def phase_kernels_dense(plan, batch: int):
    """The block SpMM at every u12-2 node width on the dense cell, on the
    whole graph: == the plain edge-list neighbor sum (``index_add_``) of the
    same function and == spmm_edgetile; on a sample of row blocks also ==
    its own dense-patch plain version, which does 146x the useful adds and
    cannot run whole.  Timed beside the edge kernel, the whole-graph plain
    version, the library call and the bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.spmm_block import spmm_block
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    dev = plan.device
    sp = plan.spmm_plan
    n_pad, e, nb = sp.n_pad, sp.num_directed, sp.num_patches
    nrb = n_pad // 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    sub_ptr, sub_col, sub_bits, sub_rows, n_sub = row_block_sample(sp, DENSE_PLAIN_BLOCKS)
    used = used_source_rows(sp)
    log(f"phase 2 dense: {nb} patches, {e / nb:.1f} edges/patch, staged source rows "
        f"{used} ({used / (nb * 128):.3f} of 128 per patch)")
    csr = torch.sparse_csr_tensor(sp.indptr, sp.indices.long(), torch.ones(e, device=dev),
                                  (n_pad, n_pad))
    block_bytes = nb * 128 * 4 * 4 + (nrb + 1 + nb) * 4
    rows = []
    widths = {}
    for i, nd in plan.chain.internal_nodes():
        widths[plan.widths[nd.right]] = widths.get(plan.widths[nd.right], 0) + 1
    for w, mult in sorted(widths.items()):
        shape = f"B={batch} W={w} x{mult}"
        bw = batch * w
        table = torch.randint(0, 4, (n_pad, batch, w), generator=gen, device=dev).float()
        table[plan.n:] = 0
        got = spmm_block(sp.patch_ptr, sp.patch_col, sp.patch_bits, table)
        edges_equal = torch.equal(got, spmm_edge_tile(sp.indptr, sp.indices, table))
        err = max_abs_err(got, ref.spmm_segment_ref(sp.indptr, sp.indices, table))
        plain = ref.spmm_block_ref(sub_ptr, sub_col, sub_bits, table)
        sub = spmm_block(sub_ptr, sub_col, sub_bits, table)
        sub_err = max(max_abs_err(sub, plain), max_abs_err(got[sub_rows], plain[sub_rows]))
        del got, sub, plain
        if err != 0 or sub_err != 0 or not edges_equal:
            raise AssertionError(f"spmm_block at {shape}: max_abs_err vs the whole-graph plain "
                                 f"version {err}, vs the dense-patch one on {n_sub} row blocks "
                                 f"{sub_err}; == spmm_edgetile {edges_equal}")
        flat = table.reshape(n_pad, -1)
        row = dict(
            shape=shape, mult=mult, err=err,
            ms=cuda_ms(lambda: spmm_block(sp.patch_ptr, sp.patch_col, sp.patch_bits, table)),
            edgetile_ms=cuda_ms(lambda: spmm_edge_tile(sp.indptr, sp.indices, table)),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, flat)),
            plain_ms=cuda_ms(lambda: ref.spmm_segment_ref(sp.indptr, sp.indices, table), 1),
            block_ref_ms=cuda_ms(lambda: ref.spmm_block_ref(sub_ptr, sub_col, sub_bits, table), 1),
            sample_ms=cuda_ms(lambda: spmm_block(sub_ptr, sub_col, sub_bits, table)),
            bound=bound_ms(block_bytes + 2 * n_pad * bw * 4, e * bw),
            staging_ms=used * bw * 4 / HBM_BYTES_PER_S * 1e3,
            gather_ms=e * bw * 4 / HBM_BYTES_PER_S * 1e3)
        rows.append(row)
        del table, flat
        torch.cuda.empty_cache()
        log(f"phase 2 dense {shape}: spmm_block {row['ms']:.3f}ms  spmm_edgetile "
            f"{row['edgetile_ms']:.3f}ms  plain {row['plain_ms']:.1f}ms  library "
            f"{row['library_ms']:.3f}ms  bound {row['bound'][0]:.3f} {row['bound'][1]} (staging "
            f"{row['staging_ms']:.1f}, gather {row['gather_ms']:.1f}); on {n_sub} of {nrb} row "
            f"blocks: dense-patch plain {row['block_ref_ms']:.1f}ms, kernel "
            f"{row['sample_ms']:.3f}ms")
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
            for kind in ("edges", "blocks"):
                for fuse in (False, True):
                    plan = build_counting_plan(g, tree, spmm_kind=kind, fuse=fuse, device=device)
                    got = float(colorful_map_count(plan, coloring))
                    if got != want:
                        raise AssertionError(f"{g.name} {name} {kind} fuse={fuse}: {got} != "
                                             f"brute force {want}")
            checked += 1
            log(f"phase 3 {g.name} {name}: {want} colorful maps; edges and blocks, fused and "
                f"unfused == brute force")


def plain_maps(plan, colorings) -> float:
    """Colorful maps of one coloring through the plain versions on the card
    (the edge-list neighbor sum, ``index_add_``, for either plan kind)."""
    from repro_torch.core.table_program import leaf_table, root_count, run_table_program
    from repro_torch.kernels import ref

    sp = plan.spmm_plan

    def plain_node(i, tbl, c_left, c_right):
        m = ref.spmm_segment_ref(sp.indptr, sp.indices, c_right)
        return ref.color_combine_ref(c_left, m, tbl.idx1, tbl.idx2)

    (maps,) = run_table_program(plan.chain, plan.combine, leaf_table(colorings, plan.k, plan.n),
                                plan.n, plain_node, root_fn=root_count)
    return maps.item()


def phase_main(plan, batch: int, calls: int):
    """The main path at full width; returns the kernels' launch counts."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.count_engine import colorful_map_count, count_fn, draw_colorings
    from repro_torch.core.estimator import call_key

    dev = plan.device
    key = prng.key(0)
    n_internal = len(plan.chain.internal_nodes())
    results = {}
    # drawing colorings launches threefry's integer kernels, loaded at first
    # use: warm them outside the timer and time one draw of the batch; the
    # card's draw must equal the CPU's, which the CPU tests hold == jax.random
    draw_ms = cuda_ms(lambda: draw_colorings(plan, batch, key))
    on_cpu = prng.randint(key, (batch, plan.n_pad), 0, plan.k, device="cpu")
    if not torch.equal(draw_colorings(plan, batch, key).cpu(), on_cpu):
        raise AssertionError("colorings drawn on the card differ from the CPU's")
    log(f"phase 4: drawing {batch} colorings of {plan.n_pad} vertices takes {draw_ms:.3f} ms; "
        f"== the CPU's draw")
    reset_launches()
    for fuse in (False, True):
        p = dataclasses.replace(plan, fuse=fuse)
        f = count_fn(p, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        maps = []
        t0 = time.perf_counter()
        for c in range(calls):
            m, est = f(call_key(key, c))
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
    launches = read_launches()
    want = n_internal * calls
    if launches != {"spmm_edgetile": want, "spmm_block": 0, "color_combine": want,
                    "fused_count": want}:
        raise AssertionError(f"launch counts {launches}, plan predicts {want} each")
    # the unfused DP alone, on colorings drawn before the timer: what the
    # draw adds to the end-to-end time
    drawn = [draw_colorings(plan, batch, call_key(key, c)) for c in range(calls)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = torch.cat([colorful_map_count(plan, cols) for cols in drawn])
    torch.cuda.synchronize()
    predrawn_ms = (time.perf_counter() - t0) / (batch * calls) * 1e3
    if not torch.equal(again, results[False][0]):
        raise AssertionError("the DP on pre-drawn colorings gave other maps")
    log(f"phase 4 fuse=False, colorings drawn before the timer: {predrawn_ms:.1f} ms/coloring")
    if not torch.equal(results[False][0], results[True][0]):
        raise AssertionError("fused and unfused maps differ")
    if not results[True][2] < results[False][2]:
        raise AssertionError(f"fused peak {results[True][2]} not below unfused {results[False][2]}")
    # coloring 0 of call 0 through the plain versions on the card
    got = results[False][0][0].item()
    plain = plain_maps(plan, draw_colorings(plan, batch, call_key(key, 0))[:1])
    if not math.isclose(plain, got, rel_tol=PLAIN_RTOL):
        raise AssertionError(f"kernels {got} vs plain versions {plain} beyond rtol {PLAIN_RTOL}")
    log(f"phase 4: fused == unfused bitwise over {batch * calls} colorings; launches {launches}; "
        f"plain versions {plain!r} vs kernels {got!r} "
        f"(rel {abs(plain - got) / max(abs(got), 1):.2e}); "
        f"est/coloring {got * plan.scale:.6g}")
    per = {f: (dt / (batch * calls) * 1e3, peak) for f, (_, dt, peak) in results.items()}
    return launches, per, (draw_ms, predrawn_ms)


def phase_dense(g, dev):
    """Counter.estimate on the dense cell with spmm_kind="auto" (the block
    plan), then "edges"; one plan lives at a time, so the peaks compare."""
    import numpy as np
    import torch
    from repro_torch.api import Counter
    from repro_torch.core import prng
    from repro_torch.core.count_engine import draw_colorings
    from repro_torch.core.estimator import call_key

    key = prng.key(0)
    runs = {}
    for kind, want_kind, spmm in (("auto", "blocks", "spmm_block"),
                                  ("edges", "edges", "spmm_edgetile")):
        counter = Counter.from_graph(g, "u12-2", backend="single", spmm_kind=kind, device=dev)
        t0 = time.perf_counter()
        plan = counter.plan
        log(f"phase 5 spmm_kind={kind}: plan kind={plan.spmm_plan.kind} (density "
            f"{plan.spmm_plan.patch_density}) in {time.perf_counter() - t0:.1f}s")
        if plan.spmm_plan.kind != want_kind:
            raise AssertionError(f"spmm_kind={kind} planned {plan.spmm_plan.kind}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        res = counter.estimate(n_iter=DENSE_ITERS, batch=DENSE_BATCH, key=key)
        dt = time.perf_counter() - t0  # the estimator copied every result to the host
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        want = len(plan.chain.internal_nodes()) * -(-DENSE_ITERS // DENSE_BATCH)
        expect = {"spmm_edgetile": 0, "spmm_block": 0, "color_combine": want, "fused_count": 0}
        expect[spmm] = want
        if launches != expect:
            raise AssertionError(f"spmm_kind={kind}: launch counts {launches}, plan predicts {expect}")
        if res.samples.shape != (DENSE_ITERS,) or not np.isfinite(res.samples).all():
            raise AssertionError(f"spmm_kind={kind}: bad samples {res.samples}")
        runs[kind] = dict(res=res, ms=dt / DENSE_ITERS * 1e3, peak=peak, launches=launches)
        log(f"phase 5 spmm_kind={kind}: {DENSE_ITERS} colorings in {dt:.2f}s "
            f"({dt / DENSE_ITERS * 1e3:.1f} ms/coloring), peak {peak / 2 ** 30:.2f} GiB, "
            f"estimate {res.estimate:.6g} RSD {res.relative_sd:.3f}; launches {launches}")
        if kind == "edges":  # the plain pass needs only the CSR, which both plans carry
            colorings = draw_colorings(plan, DENSE_BATCH, call_key(key, 0))[:1]
            plain, scale = plain_maps(plan, colorings), plan.scale
        del counter, plan
        torch.cuda.empty_cache()
    a, b = runs["auto"]["res"], runs["edges"]["res"]
    if not np.array_equal(a.samples, b.samples):
        raise AssertionError(f"block and edge samples differ: {a.samples} vs {b.samples}")
    got = float(a.samples[0] / scale)
    if not math.isclose(plain, got, rel_tol=PLAIN_RTOL):
        raise AssertionError(f"kernels {got} vs plain versions {plain} beyond rtol {PLAIN_RTOL}")
    log(f"phase 5: blocks == edges bitwise over {DENSE_ITERS} samples; plain versions "
        f"{plain!r} vs kernels {got!r} (rel {abs(plain - got) / max(abs(got), 1):.2e})")
    return {kind: dict(ms_per_coloring=r["ms"], peak_bytes=r["peak"], launches=r["launches"])
            for kind, r in runs.items()}


def _launch(argv):
    from repro_torch.launch.count import main as count_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        count_main(argv)
    out = buf.getvalue()
    log("".join(f"  {line}\n" for line in out.splitlines()).rstrip())
    return out.splitlines()


def _estimates(lines):
    return [ln for ln in lines if ln.startswith("estimate")]


def phase_launch():
    from repro_torch.core.graphs import rmat, save_npz

    base = ["--config", "bench-small", "--mode", "single", "--iters", "8", "--batch", "4"]
    plain, fused = _launch(base), _launch(base + ["--fuse"])
    if not _estimates(plain) or _estimates(plain) != _estimates(fused):
        raise AssertionError(f"launcher estimates differ: {plain} vs {fused}")
    log("phase 6: launcher estimates identical with and without --fuse")
    with tempfile.TemporaryDirectory(prefix=".smoke_tmp", dir=ROOT) as tmp:
        ckpt = str(Path(tmp) / "ckpt")
        first = _launch(base + ["--checkpoint-dir", ckpt])
        again = _launch(base + ["--resume", ckpt])
        if _estimates(first) != _estimates(plain) or _estimates(again) != _estimates(plain):
            raise AssertionError(f"checkpointed or resumed estimates differ: {first} / {again}")
        if "resumed: 8 colorings restored from checkpoint (progress/RSD include them)" not in again:
            raise AssertionError(f"--resume restored nothing: {again}")
        log("phase 6: --checkpoint-dir then --resume print the same estimate")
        path = str(Path(tmp) / "dense.npz")
        save_npz(rmat(2 ** 12, 500_000, skew=3, seed=0), path)
        dense = ["--graph", path] + base
        fused = _launch(dense + ["--fuse", "--spmm-kind", "auto"])
        blocks = _launch(dense + ["--spmm-kind", "auto"])
    if not any(ln.startswith("mode=single(batch=4,fuse=True,spmm=edges)") for ln in fused):
        raise AssertionError(f"--fuse --spmm-kind auto did not fuse over edges: {fused}")
    if "kind=blocks" not in " ".join(blocks) or _estimates(blocks) != _estimates(fused):
        raise AssertionError(f"unfused auto on the dense file: {blocks}")
    log("phase 6: --fuse --spmm-kind auto on a dense graph runs fused over edges "
        "(unfused auto picks blocks; same estimates)")


# ---------------------------------------------------------------------------


def kernels_line(rows, dense_rows, launches, per, draw_ms, dense, card):
    meta = {
        "spmm_edgetile": ("src/repro_torch/kernels/csrc/spmm_edgetile.cu",
                          "src/repro/kernels/spmm_edgetile.py:137"),
        "spmm_block": ("src/repro_torch/kernels/csrc/spmm_block.cu",
                       "src/repro/kernels/spmm_edgetile.py:73"),
        "color_combine": ("src/repro_torch/kernels/csrc/color_combine.cu",
                          "src/repro/kernels/color_combine.py:56"),
        "fused_count": ("src/repro_torch/kernels/csrc/fused_count.cu",
                        "src/repro/kernels/fused_count.py:105"),
    }
    rows = dict(rows, spmm_block=dense_rows)
    out = []
    for name in meta:
        shapes = rows[name]
        # one DP pass of u12-2 at the cell's batch: each node shape times its count
        tot = lambda key: sum(r[key] * r["mult"] for r in shapes)  # noqa: E731
        b_ms = sum(r["bound"][0] * r["mult"] for r in shapes)
        b_by = max(shapes, key=lambda r: r["bound"][0] * r["mult"])["bound"][1]
        src, rep = meta[name]
        lib = tot("library_ms") if shapes[0]["library_ms"] is not None else None
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(p[name] for p in launches.values()),
            "launches_by_path": {path: p[name] for path, p in launches.items()},
            "max_abs_err": max(r["err"] for r in shapes),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "check": "exact (==)",
            "cell": "dense" if name == "spmm_block" else "main",
            "per_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms")}
                          | {"bound_ms": r["bound"][0], "gather_bound_ms": r["gather_ms"]}
                          | {k: r[k] for k in ("edgetile_ms", "staging_ms") if k in r}
                          | ({f"block_ref_ms_{DENSE_PLAIN_BLOCKS}_row_blocks": r["block_ref_ms"],
                              f"kernel_ms_{DENSE_PLAIN_BLOCKS}_row_blocks": r["sample_ms"]}
                             if "block_ref_ms" in r else {})
                          for r in shapes],
        }
        if name == "spmm_block":
            entry |= {"edgetile_ms": tot("edgetile_ms"), "staging_bound_ms": tot("staging_ms"),
                      "plain": "spmm_segment_ref (index_add_) on the whole graph",
                      f"block_ref_ms_{DENSE_PLAIN_BLOCKS}_row_blocks": tot("block_ref_ms"),
                      f"kernel_ms_{DENSE_PLAIN_BLOCKS}_row_blocks": tot("sample_ms"),
                      "library": "torch.sparse.mm, CSR"}
        out.append(entry)
    main_path = {("fused" if fuse else "unfused"): {"ms_per_coloring": ms, "peak_bytes": peak}
                 for fuse, (ms, peak) in per.items()}
    main_path["draw_colorings_ms"], main_path["unfused_predrawn_ms_per_coloring"] = draw_ms
    return {"kernels": out, "card": card, "batch": {"main": MAIN_BATCH, "dense": DENSE_BATCH},
            "time_unit": "ms per u12-2 DP pass over all node shapes", "main_path": main_path,
            "dense_path": dense}


def run_phases(dev):
    """Every phase in order on ``dev``; returns what the kernels line reports."""
    import torch
    from repro_torch.core.count_engine import build_counting_plan
    from repro_torch.core.templates import template

    phase_build()
    g = rmat_graph(2 ** 20, 10_000_000)
    t0 = time.perf_counter()
    plan = build_counting_plan(g, template("u12-2"), device=dev)
    log(f"u12-2 plan on {dev}: n_pad={plan.n_pad} in {time.perf_counter() - t0:.1f}s")
    rows = phase_kernels(plan, MAIN_BATCH)
    phase_exact(dev)
    main_launches, per, draw_ms = phase_main(plan, MAIN_BATCH, MAIN_CALLS)
    del plan, g
    torch.cuda.empty_cache()
    dense_graph = rmat_graph(2 ** 16, 16_000_000)
    t0 = time.perf_counter()
    dplan = build_counting_plan(dense_graph, template("u12-2"), spmm_kind="auto", device=dev)
    log(f"u12-2 dense plan on {dev}: kind={dplan.spmm_plan.kind} n_pad={dplan.n_pad} "
        f"{dplan.spmm_plan.num_patches} patches in {time.perf_counter() - t0:.1f}s")
    if dplan.spmm_plan.kind != "blocks":
        raise AssertionError(f"spmm_kind='auto' planned {dplan.spmm_plan.kind} on the dense cell")
    dense_rows = phase_kernels_dense(dplan, DENSE_BATCH)
    del dplan
    torch.cuda.empty_cache()
    dense = phase_dense(dense_graph, dev)
    del dense_graph
    phase_launch()
    launches = {"main": main_launches,
                "dense": {k: dense["auto"]["launches"][k] + dense["edges"]["launches"][k]
                          for k in main_launches}}
    for name in main_launches:
        if not sum(p[name] for p in launches.values()):
            raise AssertionError(f"{name} was never launched on a path: {launches}")
    return rows, dense_rows, launches, per, draw_ms, dense


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    results = run_phases(torch.device("cuda", 0))
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(kernels_line(*results, card)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
