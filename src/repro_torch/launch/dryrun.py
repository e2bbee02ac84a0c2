"""Counting dry-run: one rank of a paper-scale cell, on ``meta`` tensors.

Counterpart of the counting half of ``repro/launch/dryrun.py``
(``run_counting_cell``, ``_compaction_report``, ``_emit``, ``main``).  The
reference lowers and compiles its program against shape structs and reads
XLA's analyses; here nothing is lowered.  The port's own per-rank program
(``make_count_fn(..., return_raw=True)``) runs once on the shape-only plan
(:func:`~repro_torch.core.distributed.abstract_plan`) and an
:class:`~repro_torch.comm.abstract.AbstractMesh` rank, every tensor on
``meta``, under :class:`LiveBytes`, a dispatch mode that follows each
``meta`` storage from the op that makes it to its release (by weak
reference).  The record carries:

* ``memory``: ``argument_bytes`` (the rank's colorings, its shard's arrays
  and the split tables), ``output_bytes`` (the counts) and ``temp_bytes``
  (the peak of what the call holds beside its arguments, less its
  output): the counterpart of XLA's ``memory_analysis()``.  Every storage
  counts at the card allocator's granularity (:data:`ALLOC_GRANULE`), so
  the sum is what ``torch.cuda.max_memory_allocated`` would read.  Beside
  them ``settled_bytes``, the most held between two ops: the ranks of one
  process (a ``LocalMesh``) run their ops one at a time and seldom at the
  same point, so such a process holds about the split tables once, each
  rank's arguments and settled bytes, and one rank's excess over them;
* ``cost``: the kernels' work as their shape-only branches record it
  (:mod:`repro_torch.kernels.work`: float32 adds and FMAs, bytes) and, for
  every other op, the bytes of its inputs and outputs (views and empty
  allocations move none): the counterpart of ``cost_analysis()``;
* ``collectives``: the rank's bytes by kind under the ring model
  (:class:`~repro_torch.comm.abstract.AbstractGroup`), in place of the
  reference's HLO parse;
* ``compaction`` (:func:`_compaction_report`), ``routing``
  (``plan_route_report``) and ``spmm_auto_density_model``, as the
  reference's record has them, and the launches by kernel.

``analysis_s`` replaces the reference's ``compile_s``: there is no compile.
Nothing is allocated and no device is touched; the compaction probe and
the split tables run on the host at plan time.

The reference's production mesh lays 16 shards on its data axis.  Its
``bench-*`` rows have 8, which its dry-run refuses (``make_count_fn``
asserts the data axis equals the shard count); here their 8 shards take the
data axis and the rest of the chips the iteration axis.  The LM half of the
reference's dry-run (``run_cell``: ``train_step``, prefill and decode under
sharding specs) waits for ROADMAP queue 1 item 17: its train cells set
``seq_axis="model"`` and lower all ten rows, and the port's mesh runs
neither sequence parallelism nor the four rows whose pattern is not
``("attn",)`` yet (the specs of all ten rows, and the rank program of the
six others, are ported).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --counting twitter-u12-2 \\
        [--multi-pod] [--counting-mode ring] [--out DIR]
    PYTHONPATH=src python -m repro_torch.roofline.analysis DIR
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref
from typing import Iterable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from ..comm.abstract import AbstractMesh
from ..configs.subgraph import COUNTING_CONFIGS
from ..kernels import ops, work
from .mesh import make_production_mesh

__all__ = ["ALLOC_GRANULE", "LiveBytes", "measure_rank", "run_counting_cell", "main"]

#: the CUDA caching allocator's block granule: every allocation of n > 0
#: bytes takes ``ceil(n / 512) * 512``, and that is what it counts
ALLOC_GRANULE = 512

#: allocations that write nothing
_EMPTY_OPS = frozenset({"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided"})


def granule_bytes(nbytes: int) -> int:
    """``nbytes`` as the card's allocator counts them."""
    return -(-int(nbytes) // ALLOC_GRANULE) * ALLOC_GRANULE


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _logical_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class LiveBytes(TorchDispatchMode):
    """Live, peak and moved bytes of the ops run under it.

    A storage made by an op (none of the op's inputs holds it) counts from
    then on, at :func:`granule_bytes`, until it is released: a weak
    reference's finalizer takes it off, as the caching allocator would on
    the tensor's last release.  ``peak`` is the most counted at once;
    ``settled`` the most counted between two ops (at each op's start), which
    leaves out what lives only while one op runs (its output beside inputs
    freed right after it).  The storages of ``arguments`` are known and
    never counted.  ``moved`` adds each op's input and output bytes, except
    views and empty allocations.
    """

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        self._known = {id(t.untyped_storage()): None for t in arguments}
        self._args = list(arguments)  # keep the arguments' storages, and so their ids, alive
        self.live = 0
        self.peak = 0
        self.settled = 0
        self.moved = 0

    def _release(self, key: int, nbytes: int) -> None:
        self._known.pop(key, None)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.settled = max(self.settled, self.live)
        out = func(*args, **(kwargs or {}))
        inputs = _tensors((args, kwargs))
        outputs = _tensors(out)
        held = {id(t.untyped_storage()) for t in inputs}
        for t in outputs:
            storage = t.untyped_storage()
            key = id(storage)
            if key in held or key in self._known:
                continue
            nbytes = granule_bytes(storage.nbytes())
            self._known[key] = None
            self.live += nbytes
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._release, key, nbytes)
        if not (getattr(func, "is_view", False) or func.overloadpacket.__name__ in _EMPTY_OPS):
            self.moved += sum(_logical_bytes(t) for t in inputs + outputs)
        return out


def _storage_bytes(tensors: Iterable[torch.Tensor]) -> int:
    """Distinct storages' bytes at the allocator's granule."""
    seen = {}
    for t in tensors:
        s = t.untyped_storage()
        seen[id(s)] = granule_bytes(s.nbytes())
    return sum(seen.values())


def _shard_tensors(arrays) -> list:
    out = [arrays.a2a.indptr, arrays.a2a.indices, arrays.buckets.indptr, *arrays.buckets.indices,
           arrays.send_idx]
    return out + ([arrays.pin_adj] if arrays.pin_adj is not None else [])


def measure_rank(plan, mesh: AbstractMesh, *, batch: int = 1, **count_kw) -> dict:
    """Run data rank ``mesh.rank`` of ``make_count_fn(plan, mesh,
    **count_kw)``'s program on ``batch`` colorings, all on ``meta``
    (``plan.device`` must be the mesh's: an :func:`abstract_plan` or a real
    plan's ``.to("meta")``).  Returns its ``memory``, ``cost``,
    ``collectives`` and ``launches``."""
    from ..core.distributed import make_count_fn

    program, _ = make_count_fn(plan, mesh, return_raw=True, **count_kw)
    colorings = torch.empty((batch, plan.n_loc_pad), dtype=torch.int32, device=mesh.device)
    arrays = plan.shard_arrays(mesh.rank, mesh.device)
    shared = [t for tbl in plan.combine.values() for t in (tbl.idx1, tbl.idx2, tbl.pairs)]
    arguments = [colorings, *_shard_tensors(arrays), *shared]
    with work.LaunchLog() as log, LiveBytes(arguments) as live:
        out = mesh.run(lambda ctx: program(ctx, colorings))[0]
    output = _storage_bytes([out])
    kernels = log.work()
    return {
        "memory": {
            "argument_bytes": _storage_bytes(arguments),
            "output_bytes": output,
            "temp_bytes": max(live.peak - output, 0),
            # temporaries and output held between two ops: what the rank
            # holds while another rank of its process runs one
            "settled_bytes": max(live.settled, live.live),
            # the split tables: one copy a process, shared by its ranks
            "shared_bytes": _storage_bytes(shared),
            "colorings_bytes": _storage_bytes([colorings]),
        },
        "cost": {
            "flops": kernels.flops,
            "fp32_ops": kernels.adds + kernels.fmas,
            "bf16_flops": kernels.bf16_flops,
            "bytes_accessed": kernels.bytes + live.moved,
            "kernel_bytes": kernels.bytes,
        },
        "collectives": mesh.collectives.as_dict(),
        "launches": log.counts(),
    }


def _compaction_report(plan, mode: str, wire_dtype: str = "float32") -> Optional[dict]:
    """Per-node density, capacities and wire bytes of a compacted plan (the
    reference's ``dryrun.py:300``); None where the plan is dense."""
    spec = plan.compaction
    if spec is None:
        return None
    from ..core.frontier import node_exchange_bytes

    per_node = {}
    bytes_dense = bytes_compact = 0
    caps = spec.shard_caps if mode == "ring" else spec.exchange_caps
    for i, nd in enumerate(plan.program.nodes):
        if nd.is_leaf:
            continue
        nb_dense, nb_compact = node_exchange_bytes(plan, i, mode, wire_dtype=wire_dtype)
        bytes_dense += nb_dense
        bytes_compact += nb_compact
        per_node[str(i)] = {
            "size": nd.size,
            "density": round(spec.density.get(i, 1.0), 4),
            "exchange_cap": caps.get(nd.right),
            "combine_cap": spec.combine_caps.get(i),
        }
    return {
        "threshold": spec.threshold,
        "capacity_factor": spec.capacity_factor,
        "per_node": per_node,
        "exchange_bytes_dense": bytes_dense,
        "exchange_bytes_compact": bytes_compact,
        "exchange_bytes_saved_frac": round(1.0 - bytes_compact / max(bytes_dense, 1), 4),
    }


def cell_mesh(ccfg, multi_pod: bool):
    """``(mesh, shards, tag, chips)`` of a counting row: a flat row's graph
    over all the chips, a grid row's shards on the production mesh's data
    axis (or, where they are not 16, on a data axis of their own with the
    rest of the chips on the iteration axis)."""
    chips = 512 if multi_pod else 256
    tag = "2x16x16" if multi_pod else "16x16"
    if ccfg.mesh_kind == "flat":
        return AbstractMesh(chips, 1, axes=(("data", chips),)), chips, "flat" + tag, chips
    mesh = make_production_mesh(multi_pod=multi_pod)
    if mesh.data_size != ccfg.num_shards:
        mesh = AbstractMesh(ccfg.num_shards, chips // ccfg.num_shards)
    return mesh, ccfg.num_shards, tag, chips


def run_counting_cell(name: str, multi_pod: bool, out_dir: Optional[str] = None,
                      mode: Optional[str] = None) -> dict:
    """Dry-run one ``COUNTING_CONFIGS`` row at its paper-scale shapes."""
    from ..core.distributed import abstract_plan, plan_route_report
    from ..core.templates import template

    ccfg = COUNTING_CONFIGS[name]
    mode = mode or ccfg.mode
    mesh, num_shards, mesh_tag, chips = cell_mesh(ccfg, multi_pod)
    tmpl = [template(t) for t in ccfg.templates] if ccfg.templates else template(ccfg.template)
    t0 = time.perf_counter()
    try:
        plan = abstract_plan(ccfg.num_vertices, ccfg.num_edges, tmpl, num_shards,
                             compact_requests=mode != "ring", compact=ccfg.compact,
                             density_threshold=ccfg.density_threshold,
                             capacity_factor=ccfg.capacity_factor)
        measured = measure_rank(plan, mesh, mode=mode, group_factor=ccfg.group_factor,
                                wire_dtype=ccfg.wire_dtype)
        rec = {
            "arch": f"counting:{name}",
            "shape": "+".join(ccfg.templates) if ccfg.templates else ccfg.template,
            "mesh": mesh_tag,
            "mesh_axes": dict(zip(mesh.axis_names, mesh.shape)),
            "mode": mode,
            "status": "ok",
            "chips": chips,
            "data_ranks": num_shards,
            "num_templates": max(len(ccfg.templates), 1),
            "batch": 1,
            "fuse": False,
            "wire_dtype": ccfg.wire_dtype,
            # the spmm_kind="auto" signal at this cell's shape: a real plan
            # measures it, a shape-only one carries the placement model
            "spmm_auto_density_model": round(
                ops.expected_patch_density(ccfg.num_vertices, 2 * ccfg.num_edges), 2),
            "compaction": _compaction_report(plan, mode, ccfg.wire_dtype),
            # the router's model costs at this shape (no calibration probe)
            "routing": plan_route_report(plan, mode=mode, group_factor=ccfg.group_factor,
                                         wire_dtype=ccfg.wire_dtype),
            "analysis_s": time.perf_counter() - t0,
            **measured,
        }
    except Exception as e:  # noqa: BLE001 - a failing cell is a report, as the reference's
        rec = {"arch": f"counting:{name}", "mesh": mesh_tag, "mode": mode, "status": "error",
               "error": f"{type(e).__name__}: {e}", "traceback": traceback.format_exc()[-2000:]}
    _emit(rec, out_dir)
    return rec


def _emit(rec: dict, out_dir: Optional[str]) -> None:
    """Print the record as one JSON line and, with ``out_dir``, write it to
    ``<arch>_<shape>_<mesh>[_<mode>].json`` there (the reference's names)."""
    line = json.dumps(rec)
    print(line, flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{rec['arch'].replace(':', '_')}_{rec.get('shape', 'x')}_{rec['mesh']}"
        if rec.get("mode"):
            tag += f"_{rec['mode']}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            f.write(line)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--counting", help="a COUNTING_CONFIGS row")
    ap.add_argument("--counting-mode", help="override the row's exchange mode")
    ap.add_argument("--out", default=None, help="directory for the record's JSON file")
    args = ap.parse_args(argv)
    if args.counting:
        rec = run_counting_cell(args.counting, args.multi_pod, args.out, args.counting_mode)
        return 0 if rec["status"] == "ok" else 1
    if args.all or args.arch:
        raise NotImplementedError(
            "the LM dry-run (--arch, --all) lowers every row's train_step, prefill and "
            "decode with sequence parallelism: ROADMAP queue 1 item 17")
    ap.error("give --counting ROW")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
