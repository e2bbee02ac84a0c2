"""Dry-run: one rank of a paper-scale cell, on ``meta`` tensors.

Counterpart of ``repro/launch/dryrun.py``: its counting half
(``run_counting_cell``, ``_compaction_report``) and its LM half
(``sharding_for``, ``skip_reason``, ``lower_cell``/``_measure``/``run_cell``),
with ``_emit`` and ``main``.  The reference lowers and compiles its program
against shape structs and reads XLA's analyses; here nothing is lowered.
The port's own per-rank program runs once on an
:class:`~repro_torch.comm.abstract.AbstractMesh` rank, every tensor on
``meta``, under :class:`LiveBytes`, a dispatch mode that follows each
``meta`` storage from the op that makes it to its release (by weak
reference).

**Counting** (``--counting ROW``): ``make_count_fn(..., return_raw=True)``
on the shape-only plan (:func:`~repro_torch.core.distributed.abstract_plan`).
The record carries:

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

The reference's production mesh lays 16 shards on its data axis.  Its
``bench-*`` rows have 8, which its dry-run refuses (``make_count_fn``
asserts the data axis equals the shard count); here their 8 shards take the
data axis and the rest of the chips the iteration axis.  On the multi-pod
mesh the pods fold into the iteration axis, as the reference's
``iter_axis=("pod", "model")``.

**LM** (``--arch A --shape S``, ``--all``): every row of ``configs.ARCHS``
at each ``SHAPES`` cell on the LM's view of the production mesh
(``make_production_mesh(...).lm_view()``: 16 x 16, or pods 2 x 16 x 16),
with the reference's :func:`sharding_for` and :func:`skip_reason` (and its
``DRYRUN_SP_DIM``, ``DRYRUN_MOE_PIPELINE``, ``DRYRUN_ATTN_CHUNK`` and
``DRYRUN_MICROBATCHES`` variables): the rank's weights
(``Model.shard_params`` of the whole ``meta`` weights, which are no
argument) and, on a train cell, its ZeRO-1 state (``rank_opt_state``)
through ``make_train_step``; prefill and decode through ``prefill_fn`` and
``decode_fn`` on the rank's rows and caches (:func:`measure_lm`).  Beside
``LiveBytes`` and ``work.LaunchLog`` (flash's shape-only branch),
``torch.utils.flop_counter.FlopCounterMode`` counts the GEMMs.  The record
keeps the reference's fields and carries ``memory`` (``argument_bytes``:
weights, state, inputs and caches; ``output_bytes``; ``temp_bytes``;
``alias_bytes``: what the call updates in place, the train step's weights
and state, where the reference donates them, and decode's caches),
``cost`` (``flops``: the counted GEMMs plus flash's; ``bytes_accessed``),
``collectives`` (the pod group's bytes included; the port's reduce-scatters
are all-to-alls and count as such, at the same bytes) and ``launches``.
Departures: the reference's ``_corrected`` and its depth probes mend XLA
counting a scan body once; the port runs every layer, so its cost is whole
and the record has ``cost_raw == cost`` and no ``probe``.  Decode runs at
``pos = seq_len - 1`` (a Python int: the port's decode takes the position
on the host).

``analysis_s`` replaces the reference's ``lower_s`` and ``compile_s``:
there is no compile.  Nothing is allocated and no device is touched; the
compaction probe and the split tables run on the host at plan time.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --counting twitter-u12-2 \\
        [--multi-pod] [--counting-mode ring] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b \\
        --shape train_4k [--multi-pod] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--out DIR]
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
from ..configs import ARCHS, get_arch
from ..configs.base import SHAPES, ShardingConfig
from ..configs.subgraph import COUNTING_CONFIGS
from ..kernels import ops, work
from .mesh import make_production_mesh

__all__ = ["ALLOC_GRANULE", "FSDP_THRESHOLD", "LiveBytes", "measure_rank", "measure_lm",
           "sharding_for", "skip_reason", "lm_cell", "run_cell", "run_counting_cell", "main"]

#: weights above this many get ZeRO-3 weight sharding (the reference's)
FSDP_THRESHOLD = 2e9

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
    freed right after it); ``waiting`` the most counted where the rank
    waits for a peer (:meth:`at_wait`).  The storages of ``arguments`` are
    known and never counted.  ``moved`` adds each op's input and output bytes, except
    views and empty allocations.
    """

    def __init__(self, arguments: Iterable[torch.Tensor] = ()):
        super().__init__()
        self._known = {id(t.untyped_storage()): None for t in arguments}
        self._args = list(arguments)  # keep the arguments' storages, and so their ids, alive
        self.live = 0
        self.peak = 0
        self.settled = 0
        self.waiting = 0
        self.moved = 0

    def at_wait(self) -> None:
        """A point where the rank would wait for a peer: ``waiting`` is the
        most counted at one."""
        self.waiting = max(self.waiting, self.live)

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


# ---------------------------------------------------------------------------
# the LM half
# ---------------------------------------------------------------------------


def sharding_for(arch_name: str, shape_name: str, multi_pod: bool) -> ShardingConfig:
    """The reference's cell sharding: the batch over ``pod`` and ``data``
    (none where the global batch is smaller than those ranks), FSDP from
    :data:`FSDP_THRESHOLD` weights, full remat and sequence parallelism
    over ``model`` on train cells, and its ``DRYRUN_*`` knobs."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    dp_axes = ("pod", "data") if multi_pod else ("data",)
    dp_size = (2 * 16 if multi_pod else 16)
    if shape.global_batch < dp_size:
        dp_axes = ()  # long_500k b=1: no batch sharding
    return ShardingConfig(
        batch_axes=dp_axes,
        fsdp=cfg.params_count() >= FSDP_THRESHOLD,
        remat="full" if shape.kind == "train" else "none",
        # sequence parallelism: shard the residual stream over the model
        # axis during training (the remat carries dominate memory otherwise)
        seq_axis="model" if shape.kind == "train" else None,
        sp_dim=int(os.environ.get("DRYRUN_SP_DIM", "1")),
        moe_pipeline=os.environ.get("DRYRUN_MOE_PIPELINE", "") == "1",
        attn_chunk=int(os.environ.get("DRYRUN_ATTN_CHUNK", "1024")),
    )


def skip_reason(arch_name: str, shape_name: str) -> Optional[str]:
    """Why the reference skips a cell (None where it runs it)."""
    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.subquadratic:
        return "long_500k skipped: pure full-attention arch (see DESIGN.md §5)"
    if shape.kind == "decode" and cfg.family == "audio" and shape_name == "long_500k":
        return "long_500k skipped: enc-dec audio arch"
    return None


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def measure_lm(model, kind: str, batch: int, seq_len: int, *, microbatches: int = 1) -> dict:
    """One rank's train step (``kind="train"``), prefill or decode step of
    ``model`` (built on ``meta``: on one device, or on an
    :class:`AbstractMesh`, of whose one rank this is the program) over a
    global batch of ``batch`` sequences of ``seq_len`` tokens (decode: one
    token at ``seq_len - 1`` over caches of ``seq_len``).  Returns its
    ``memory``, ``cost``, ``collectives`` and ``launches`` (the flash
    launches by shape under ``launch_shapes``)."""
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.factory import batch_groups, context_len, row_block
    from ..train import AdamWConfig, TrainConfig, make_train_step
    from ..train.optimizer import init_opt_state
    from ..train.train_loop import rank_opt_state

    if model.device.type != "meta":
        raise ValueError(f"the dry-run runs a model built on meta, not {model.device}")
    mesh, cfg = model.mesh, model.cfg
    ctx_len, needs_ctx = context_len(cfg)
    whole = model.abstract_params()  # the whole weights: cut from, never an argument
    out: dict = {}

    def program(ctx) -> None:
        params = whole if mesh is None else model.shard_params(whole)
        weights = list(params.parameters())
        b_loc = batch if mesh is None else row_block(batch, batch_groups(model.sharding))[1]
        if kind == "decode":
            caches = model.init_caches_fn(batch, seq_len, ctx_len)
            cache_ts = [t for layer in caches for t in layer.values()]
            inputs = {"tokens": _meta((b_loc, 1), torch.int32), "pos": seq_len - 1,
                      "caches": caches}
            held, args = cache_ts, weights + cache_ts + [inputs["tokens"]]
            arg_bytes = _storage_bytes(args)
            run = lambda: model.decode_fn(params, inputs)  # noqa: E731
        else:
            rows = batch if kind == "train" else b_loc  # the train step cuts its rows
            inputs = {"tokens": _meta((rows, seq_len), torch.int32)}
            if needs_ctx:
                inputs["context"] = _meta((rows, ctx_len, cfg.d_model), torch.bfloat16)
            own = sum(granule_bytes(t.numel() // rows * b_loc * t.element_size())
                      for t in inputs.values())
            if kind == "train":
                named = dict(params.named_parameters())
                opt = init_opt_state(named) if mesh is None else rank_opt_state(model, params)
                step, _ = make_train_step(model, TrainConfig(opt=AdamWConfig(),
                                                             microbatches=microbatches))
                state = [*opt["m"].values(), *opt["v"].values()]
                held = weights + state
                args = held + list(inputs.values())
                arg_bytes = _storage_bytes(held) + own
                run = lambda: step(params, opt, inputs)  # noqa: E731
            else:
                held, args = [], weights + list(inputs.values())
                arg_bytes = _storage_bytes(weights) + own
                run = lambda: model.prefill_fn(params, inputs)  # noqa: E731
        live = LiveBytes(args)
        lives.append(live)
        with FlopCounterMode(display=False) as flops, work.LaunchLog() as log, live:
            result = run()
        known = {id(t.untyped_storage()) for t in args}
        fresh = [t for t in _tensors(result) if id(t.untyped_storage()) not in known]
        output = _storage_bytes(fresh)
        kernels = log.work()
        out.update({
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": output,
                "temp_bytes": max(live.peak - output, 0),
                "alias_bytes": _storage_bytes(held),
                # temporaries and output held between two ops: what the rank
                # holds while another rank of its process runs one
                "settled_bytes": max(live.settled, live.live),
                # held where it waits for a peer: where a rank of a
                # LocalMesh taking turns gives the host to another
                "waiting_bytes": live.waiting,
            },
            "cost": {
                "flops": float(flops.get_total_flops()) + kernels.flops,
                "gemm_flops": float(flops.get_total_flops()),
                "kernel_flops": kernels.flops,
                "bytes_accessed": kernels.bytes + live.moved,
                "kernel_bytes": kernels.bytes,
            },
            "launches": log.counts(),
            "launch_shapes": sorted({str(x.shapes) for x in log.launches}),
        })

    lives: list = []  # the run's LiveBytes, once made: the groups' waits report to it
    if mesh is None:
        program(None)
        out["collectives"] = AbstractMesh().collectives.as_dict()
        return out
    mesh.on_wait = lambda: lives and lives[0].at_wait()
    try:
        mesh.run(program)
    finally:
        mesh.on_wait = None
    out["collectives"] = mesh.collectives.as_dict()
    return out


def lm_cell(arch_name: str, shape_name: str, multi_pod: bool):
    """``(model, shape, meta)`` of one LM cell: the row's model on the LM
    view of the production mesh with :func:`sharding_for`'s sharding, the
    ``SHAPES`` cell, and the record's reference fields."""
    from ..models import build_model

    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod).lm_view()
    sh = sharding_for(arch_name, shape_name, multi_pod)
    model = build_model(cfg, sh, mesh)
    meta = {
        "arch": arch_name,
        "shape": shape_name,
        "kind": shape.kind,
        "mesh": _mesh_tag(multi_pod),
        "chips": mesh.size,
        "params": cfg.params_count(),
        "active_params": cfg.active_params_count(),
        "fsdp": sh.fsdp,
        "global_batch": shape.global_batch,
        "seq_len": shape.seq_len,
    }
    return model, shape, meta


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             out_dir: Optional[str] = None) -> dict:
    """Dry-run one (row, shape, mesh) LM cell: a skipped, ok or error record."""
    reason = skip_reason(arch_name, shape_name)
    mesh_tag = _mesh_tag(multi_pod)
    if reason:
        rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag,
               "status": "skipped", "reason": reason}
        _emit(rec, out_dir)
        return rec
    t0 = time.perf_counter()
    try:
        model, shape, meta = lm_cell(arch_name, shape_name, multi_pod)
        measured = measure_lm(model, shape.kind, shape.global_batch, shape.seq_len,
                              microbatches=int(os.environ.get("DRYRUN_MICROBATCHES", "1")))
        rec = dict(meta, status="ok", mesh_axes=dict(zip(model.mesh.axis_names,
                                                          model.mesh.shape)),
                   analysis_s=time.perf_counter() - t0, **measured)
        # every layer ran: the cost is whole, and no depth probe mends it
        rec["cost_raw"] = dict(rec["cost"])
    except Exception as e:  # noqa: BLE001 - a failing cell is a report, as the reference's
        rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_tag, "status": "error",
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
    ap.add_argument("--arch", help="an LM row (configs.ARCHS)")
    ap.add_argument("--shape", help="an LM cell (configs.base.SHAPES)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="every LM row at every shape")
    ap.add_argument("--counting", help="a COUNTING_CONFIGS row")
    ap.add_argument("--counting-mode", help="override the row's exchange mode")
    ap.add_argument("--out", default=None, help="directory for the record's JSON file")
    args = ap.parse_args(argv)
    if args.counting:
        rec = run_counting_cell(args.counting, args.multi_pod, args.out, args.counting_mode)
        return 0 if rec["status"] == "ok" else 1
    if args.all:
        ok = err = skip = 0
        for arch in sorted(ARCHS):
            for shape in SHAPES:
                status = run_cell(arch, shape, args.multi_pod, args.out)["status"]
                ok += status == "ok"
                err += status == "error"
                skip += status == "skipped"
        print(f"# dry-run summary: {ok} ok, {skip} skipped, {err} errors", flush=True)
        return 1 if err else 0
    if args.arch and args.shape:
        rec = run_cell(args.arch, args.shape, args.multi_pod, args.out)
        return 0 if rec["status"] != "error" else 1
    ap.error("give --counting ROW, --arch A --shape S, or --all")
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
