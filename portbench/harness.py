"""The benchmark of ``repro_torch``: one cell, one seed, one run.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<config>.json``: the graph generator's parameters)
and a traffic mix (``mixes/<traffic>.json``: the templates, the color
budget, the colorings a call and the plan options); its correctness limits
are ``limits/<cell>.json`` and each per-layer metric is read by
``metrics/<metric>.py``.  Nothing here names a cell: a new cell, mix,
configuration or metric is a new file and entry.

A run:

1. set-up (``setup_s``, from process start): import the port, make the
   configuration's graph on the card (``gen/<generator>.py``, drawn from
   the configuration's ``graph_seed``: one graph in one vertex order for
   every run), hand its CSR
   to ``repro_torch.core.graphs.from_csr``, build the plan (the host clock
   around it is ``plan_build_s``) and make the warm calls, which build or
   load the kernels;
2. the window: calls of the estimator's backend protocol,
   ``sample_fn(key, B)``, each with the next key of the estimator's call
   stream (``fold_in(key(seed), i)``) and each ending in its own host copy,
   back to back until ``--seconds`` have passed; the peak of device memory
   is reset at its start and read at its close; ``--trace 1`` runs it under
   ``torch.profiler``;
3. the check, once the program's state is freed: every coloring of the
   mix's ``check_calls`` calls of the window and ``check_colorings``
   colorings of its other calls, all drawn from the seed, are redrawn from
   their call's key (``frozen/threefry.py``) and counted again by the
   float64 reference (``reference/colorcoding.py``); ``correct`` holds
   where every checked estimate lies within the cell's limit of the
   reference's and every estimate of the window is finite.

The result is one JSON line on standard output; the numbers compared, each
beside its limit, are the last lines on standard error and the last key of
that line.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from portbench.frozen import threefry, work
from portbench.reference import colorcoding

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
#: top-level modules no run may hold: the JAX reference package and JAX itself
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro")
#: calls made before the window, with the window's shapes
WARM_CALLS = 1
#: device operations and idle gaps a traced result line lists
BREAKDOWN_ENTRIES = 10
GIB = float(1 << 30)


def _load(path: Path) -> Dict:
    with open(path) as fh:
        return json.load(fh)


def cell_spec(workload: str, root: Path = ROOT) -> Dict:
    """Everything a run of ``workload`` reads, found by name."""
    bench = _load(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {
        "cell": cell,
        "config": _load(root / cfg_entry["file"]),
        "mix": _load(BENCH_DIR / "mixes" / f"{cell['traffic']}.json"),
        "limits": _load(BENCH_DIR / "limits" / f"{workload}.json"),
        "end_to_end": mine(bench["end_to_end"]),
        "per_layer": mine(bench["per_layer"]),
    }


def make_graph(cfg: Dict, device) -> Dict:
    """The configuration's graph as a host CSR, from ``gen/<generator>.py``."""
    gen = _module(BENCH_DIR / "gen" / f"{cfg['generator']}.py")
    indptr, indices, stats = gen.make_csr(cfg, device)
    return {"n": int(cfg["vertices"]), "indptr": indptr, "indices": indices, "stats": stats}


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('-', '_')}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def base_key(seed: int) -> torch.Tensor:
    """The run's key: ``key(seed)``, with any bits past 32 folded in."""
    k = threefry.key(seed)
    return threefry.fold_in(k, seed >> 32) if seed >> 32 else k


# ---------------------------------------------------------------------------
# the system under test
# ---------------------------------------------------------------------------


class Program:
    """The port's counting path for one mix on one graph.

    One template: ``repro_torch.api.Counter(...).sample_fn``, the call
    ``Counter.estimate`` makes a batch.  A family: the family sampler that
    ``Counter.estimate_many`` calls on the single-device backend,
    ``count_engine.multi_sample_fn(build_multi_counting_plan(...))``.
    """

    def __init__(self, graph: Dict, mix: Dict, device):
        from repro_torch import api
        from repro_torch.core import count_engine, graphs
        from repro_torch.core.templates import Tree

        self.g = graphs.from_csr(graph["n"], graph["indptr"], graph["indices"])
        trees = tuple(Tree(t["n"], tuple(tuple(e) for e in t["edges"]), t["name"])
                      for t in mix["templates"])
        opts = dict(mix.get("plan", {}), n_colors=int(mix["n_colors"]), device=device)
        t0 = time.perf_counter()
        if len(trees) == 1:
            counter = api.Counter.from_graph(self.g, trees[0], backend="single", **opts)
            self.sample_fn = counter.sample_fn
            self.plan = counter.plan
        else:
            self.plan = count_engine.build_multi_counting_plan(self.g, trees, **opts)
            self.sample_fn = count_engine.multi_sample_fn(self.plan)
        self.plan_build_s = time.perf_counter() - t0

    def __call__(self, key: torch.Tensor, batch: int) -> np.ndarray:
        """Copy estimates ``[batch, templates]`` of the colorings ``key`` draws."""
        return np.asarray(self.sample_fn(key, batch), np.float64).reshape(batch, -1)

    def node_sizes(self) -> List[tuple]:
        """``(t1, t2)`` of each combine node of the plan's program, in the
        order the program runs them: the partition the program chose."""
        program = getattr(self.plan, "chain", None) or self.plan.dag
        return [(program.nodes[nd.left].size, program.nodes[nd.right].size)
                for nd in program.nodes if nd.kind == "combine"]


def launch_counts() -> Dict[str, int]:
    """The port's launch counters (``kernels/_build.count_launch``) of every
    kernel wrapper ``kernels/ops`` exports."""
    from repro_torch.kernels import ops

    out, seen = {}, set()
    for name in dir(ops):
        fn = getattr(ops, name)
        n = getattr(fn, "launches", None)
        if isinstance(n, int) and id(fn) not in seen:  # an alias counts once
            seen.add(id(fn))
            out[name] = n
    return out


def call_work(node_sizes: List[tuple], k: int, n: int, edges: int, batch: int,
              fuse: bool) -> Dict[str, List[work.Work]]:
    """The least work of one call's launches by kernel family, from the
    problem's shapes: each combine node of sizes ``(t1, t2)`` sums the
    neighbors of a ``C(k, t2)``-wide table over the CSR's ``edges`` and
    contracts it with a ``C(k, t1)``-wide one into ``C(k, t1 + t2)``
    columns, ``C(t1 + t2, t1)`` splits each; rows are the port's padded
    vertex axis."""
    rows = threefry.n_pad(n)
    out: Dict[str, List[work.Work]] = {"spmm_edge": [], "color_combine": [], "fused_count": []}
    for t1, t2 in node_sizes:
        a, w, s = math.comb(k, t1), math.comb(k, t2), math.comb(k, t1 + t2)
        j = math.comb(t1 + t2, t1)
        jp = -(-j // 4) * 4
        if fuse:
            out["fused_count"].append(work.fused_count(rows, rows, edges, batch, a, w, s, j, jp))
        else:
            out["spmm_edge"].append(work.spmm_edge(rows, rows, edges, batch * w))
            out["color_combine"].append(work.color_combine(rows * batch, a, w, s, j, jp))
    return out


# ---------------------------------------------------------------------------
# the window
# ---------------------------------------------------------------------------


def run_window(program: Callable, key: torch.Tensor, first: int, batch: int, seconds: float,
               device, trace: bool) -> Dict:
    """Calls with keys ``fold_in(key, first), fold_in(key, first + 1), ...``
    back to back until ``seconds`` have passed; each ends in its host copy."""
    cuda = torch.device(device).type == "cuda"
    keys = [threefry.fold_in(key, first)]
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    counts0 = launch_counts()
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    answers, ends = [], []
    t0 = time.perf_counter()
    while True:
        k = keys[-1]
        with torch.profiler.record_function("portbench.call"):
            answers.append(program(k, batch))
        t = time.perf_counter()
        ends.append(t - t0)
        if t - t0 >= seconds:
            break
        keys.append(threefry.fold_in(key, first + len(keys)))
    window_s = t - t0
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    trace_path = None
    if prof is not None:
        prof.__exit__(None, None, None)
        fd, trace_path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        prof.export_chrome_trace(trace_path)
        del prof
    counts1 = launch_counts()
    return {"answers": answers, "keys": keys, "window_s": window_s, "peak_bytes": int(peak),
            "call_s": list(np.diff([0.0] + ends)),
            "launches": {n: counts1[n] - counts0.get(n, 0) for n in counts1},
            "trace_path": trace_path}


def read_trace(path: str) -> Dict:
    """Device operations, host events and the window's bounds (microseconds)
    from a chrome trace of the window."""
    with open(path) as fh:
        events = json.load(fh)
    events = events.get("traceEvents", events) if isinstance(events, dict) else events
    device, host, calls = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat = e.get("cat", "")
        rec = (e.get("name", ""), float(e["ts"]), float(e["dur"]))
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append(rec)
        elif cat in ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"):
            host.append(rec)
            if cat == "user_annotation" and rec[0] == "portbench.call":
                calls.append(rec)
    start = min((c[1] for c in calls), default=0.0)
    end = max((c[1] + c[2] for c in calls), default=0.0)
    device = [d for d in device if d[1] < end and d[1] + d[2] > start]
    return {"device": device, "host": host, "start": start, "end": end}


def _busy_intervals(device: List[tuple], start: float, end: float) -> List[tuple]:
    spans = sorted((max(s, start), min(s + d, end)) for _, s, d in device)
    merged: List[list] = []
    for s, e in spans:
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def trace_summary(tr: Dict) -> Dict:
    """Busy and window seconds, device time by operation, and the idle
    gaps by the innermost host event running through each."""
    start, end = tr["start"], tr["end"]
    busy = _busy_intervals(tr["device"], start, end)
    busy_s = sum(e - s for s, e in busy) * 1e-6
    by_op: Dict[str, float] = {}
    for name, _, dur in tr["device"]:
        by_op[name] = by_op.get(name, 0.0) + dur * 1e-6
    gaps = []
    cursor = start
    for s, e in busy + [(end, end)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    host = sorted(tr["host"], key=lambda h: h[1])
    starts = np.array([h[1] for h in host]) if host else np.zeros(0)
    longest = max((h[2] for h in host), default=0.0)
    by_host: Dict[str, float] = {}
    for s, e in gaps:
        mid = 0.5 * (s + e)
        name, best = "no host event", math.inf
        for i in range(int(np.searchsorted(starts, mid, side="right")) - 1, -1, -1):
            h = host[i]
            if mid - h[1] > longest:  # no earlier event reaches the gap
                break
            if h[1] + h[2] >= mid and h[2] < best:
                name, best = h[0], h[2]
        by_host[name] = by_host.get(name, 0.0) + (e - s) * 1e-6
    top = lambda d: [[k[:160], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                     ][:BREAKDOWN_ENTRIES]
    return {"busy_s": busy_s, "window_s": (end - start) * 1e-6, "device_ops": top(by_op),
            "idle_gaps": top(by_host)}


def per_layer_context(program_info: Dict, win: Dict, summary: Dict, tr: Dict) -> Dict:
    """What a per-layer metric's reader may read."""
    calls = len(win["answers"])
    per_call = program_info["call_work"]
    bound = {fam: calls * sum(work.bound_s(w)[0] for w in ws) for fam, ws in per_call.items()}
    device = tr["device"]

    def kernel_seconds(part: str) -> float:
        return sum(d for name, _, d in device if part in name) * 1e-6

    def kernel_launches(part: str) -> int:
        return sum(1 for name, _, _ in device if part in name)

    return {
        "calls": calls,
        "plan_build_s": program_info["plan_build_s"],
        "launches": win["launches"],
        "bound_s": bound,
        "expected_launches": {fam: calls * len(ws) for fam, ws in per_call.items()},
        "kernel_seconds": kernel_seconds,
        "kernel_launches": kernel_launches,
        "busy_s": summary["busy_s"],
        "window_s": summary["window_s"],
    }


# ---------------------------------------------------------------------------
# the check
# ---------------------------------------------------------------------------


def check_picks(calls: int, batch: int, mix: Dict, seed: int) -> List[tuple]:
    """``(call, slot)`` of each coloring the check compares, drawn from the
    seed: every slot of ``check_calls`` calls, and ``check_colorings``
    colorings of the other calls."""
    rng = np.random.default_rng(seed)
    whole = {int(c) for c in rng.choice(calls, size=min(int(mix["check_calls"]), calls),
                                        replace=False)}
    rest = [(c, b) for c in range(calls) if c not in whole for b in range(batch)]
    more = rng.choice(len(rest), size=min(int(mix["check_colorings"]), len(rest)),
                      replace=False)
    return sorted([(c, b) for c in whole for b in range(batch)] + [rest[int(i)] for i in more])


def check_answers(spec: Dict, graph: Dict, win: Dict, seed: int, device) -> Dict:
    """The checked colorings' estimates against the float64 reference's."""
    mix = spec["mix"]
    batch, k = int(mix["batch"]), int(mix["n_colors"])
    answers = win["answers"]
    total = len(answers) * batch
    finite = sum(int(np.isfinite(a).all(axis=1).sum()) for a in answers)
    picks = check_picks(len(answers), batch, mix, seed)
    ref_graph = colorcoding.Graph(graph["n"], graph["indptr"], graph["indices"], device)
    gaps = []
    t0 = time.perf_counter()
    for call in sorted({c for c, _ in picks}):
        colorings = threefry.draw_colorings(win["keys"][call], graph["n"], k, batch,
                                            device=device)
        for b in (b for c, b in picks if c == call):
            ref = colorcoding.estimates(ref_graph, mix["templates"], colorings[b], k)
            for got, want in zip(answers[call][b].tolist(), ref):
                gaps.append(abs(got - want) / abs(want) if want else abs(got))
        del colorings
    ref_s = time.perf_counter() - t0
    del ref_graph
    gap = max(gaps) if gaps else math.inf
    limit = float(spec["limits"]["est_rel_gap"]["limit"])
    over = sum(1 for g in gaps if not g <= limit)
    return {"attempted": total, "failed": (total - finite) + over,
            "checks": {"est_rel_gap": {"value": gap, "limit": limit}},
            "reference_s": ref_s, "sampled": len(picks), "gaps": gaps}


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN_MODULES))


# ---------------------------------------------------------------------------
# a run
# ---------------------------------------------------------------------------


def run_cell(spec: Dict, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: Optional[float] = None, make_program: Callable = None,
             wrap: Optional[Callable] = None, log=None) -> Dict:
    """One run of a cell; returns the result line's object (with ``"checks"``
    last).  ``make_program(graph, mix, device)`` stands in for the port
    (the control, ``control.py``); ``wrap`` replaces the program by
    ``wrap(program)`` (the tests' faults)."""
    t_start = time.perf_counter() if t_start is None else t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    mix = spec["mix"]
    batch = int(mix["batch"])
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    t_graph = time.perf_counter()
    graph = make_graph(spec["config"], dev)
    log(f"graph {json.dumps(graph['stats'])}: {time.perf_counter() - t_graph:.3f} s, "
        f"{t_graph - t_start:.3f} s after start")
    program = (make_program or Program)(graph, mix, device)
    info = {"plan_build_s": program.plan_build_s,
            "call_work": call_work(program.node_sizes(), int(mix["n_colors"]), graph["n"],
                                   int(graph["indices"].shape[0]), batch,
                                   bool(mix.get("plan", {}).get("fuse", False)))}
    run = wrap(program) if wrap is not None else program
    key = base_key(seed)
    t_warm = time.perf_counter()
    for i in range(WARM_CALLS):
        run(threefry.fold_in(key, i), batch)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"warm calls {time.perf_counter() - t_warm:.3f} s")

    win = run_window(run, key, WARM_CALLS, batch, seconds, dev, trace)
    calls = len(win["answers"])
    log(f"window {calls} calls of {batch} colorings in {win['window_s']:.3f} s "
        f"(calls {', '.join(f'{c:.3f}' for c in win['call_s'])} s); set-up {setup_s:.3f} s "
        f"(plan {program.plan_build_s:.3f} s); peak {win['peak_bytes'] / GIB:.3f} GiB")
    del run, program
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    result: Dict = {}
    metrics: Dict[str, Dict] = {}
    tr = summary = None
    if trace:
        tr = read_trace(win["trace_path"])
        os.unlink(win["trace_path"])
        summary = trace_summary(tr)
        ctx = per_layer_context(info, win, summary, tr)
        for m in spec["per_layer"]:
            reader = _module(BENCH_DIR / "metrics" / f"{m['name']}.py")
            value = reader.read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        values = {
            "colorings_per_s": calls * batch / win["window_s"],
            "peak_device_gib": win["peak_bytes"] / GIB,
            "setup_s": setup_s,
        }
        for m in spec["end_to_end"]:
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    check = check_answers(spec, graph, win, seed, dev)
    log(f"reference: {check['sampled']} colorings in {check['reference_s']:.3f} s")
    result["correct"] = check["failed"] == 0
    result["attempted"] = check["attempted"]
    result["failed"] = check["failed"]
    result["metrics"] = metrics
    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": int(spec["cell"]["chips"]),
        "memory_peak_bytes": win["peak_bytes"],
    }
    if summary is not None:
        result["device"].update(busy_s=summary["busy_s"], window_s=summary["window_s"])
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = check["checks"]
    return result


def main(argv: Optional[List[str]] = None, t_start: Optional[float] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    spec = cell_spec(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
