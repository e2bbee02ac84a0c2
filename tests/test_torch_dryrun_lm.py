"""The LM dry-run (``launch/dryrun.py``'s LM half) against the reference and
against a real rank.

* the reference: ``sharding_for``, ``skip_reason`` and the record's
  reference fields == ``repro.launch.dryrun``'s for all ten rows x four
  shapes x both production meshes (the reference's fields computed from
  its own config, shapes and ``sharding_for``; nothing lowered);
* a real rank: a reduced row (head dim 64, so that prefill takes the flash
  wrapper) on an ``AbstractMesh`` of ``2 x 2`` and of ``(2, 2, 2)`` == rank
  0 of the same program on a CPU ``LocalMesh``: the bytes it sends by
  collective kind, the flash launches by shape, and ``argument_bytes`` ==
  its tensors' storage bytes;
* full size: smollm-360m's four shapes on both production meshes (the
  train cell at full width, its depth cut to two layers for time):
  ``argument_bytes`` == the specs' arithmetic (``comm.spec.local_shape``)
  exactly, and the rank's flops x chips >= the model's flops;
* the roofline reads the LM records.
"""

from __future__ import annotations

import dataclasses
import math
import threading

import numpy as np
import pytest
import torch

from repro_torch.comm import AbstractMesh, group as group_mod
from repro_torch.comm.spec import local_shape
from repro_torch.configs import ARCHS, SHAPES, ShardingConfig, get_arch
from repro_torch.kernels import ops, work
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.models.factory import batch_groups, mesh_axes, row_block
from repro_torch.roofline import analysis
from repro_torch.train import AdamWConfig, TrainConfig, make_train_step
from repro_torch.train.train_loop import _specs, rank_opt_state
from test_torch_dryrun import _ref_dryrun

ROWS = sorted(ARCHS)


# ---------------------------------------------------------------------------
# the reference's cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("row", ROWS)
def test_cells_equal_the_references(row):
    ref = _ref_dryrun()
    from repro.configs import get_arch as ref_get_arch
    from repro.configs.base import SHAPES as REF_SHAPES

    assert list(SHAPES) == list(REF_SHAPES)
    rcfg = ref_get_arch(row)
    for shape in SHAPES:
        assert dryrun.skip_reason(row, shape) == ref.skip_reason(row, shape)
        for multi_pod in (False, True):
            sh = dryrun.sharding_for(row, shape, multi_pod)
            assert dataclasses.asdict(sh) == dataclasses.asdict(
                ref.sharding_for(row, shape, multi_pod)), (shape, multi_pod)
            if ref.skip_reason(row, shape):
                continue
            _, _, meta = dryrun.lm_cell(row, shape, multi_pod)
            rs = REF_SHAPES[shape]
            assert meta == {
                "arch": row, "shape": shape, "kind": rs.kind,
                "mesh": "2x16x16" if multi_pod else "16x16",
                "chips": 512 if multi_pod else 256, "params": rcfg.params_count(),
                "active_params": rcfg.active_params_count(),
                "fsdp": rcfg.params_count() >= ref.FSDP_THRESHOLD,
                "global_batch": rs.global_batch, "seq_len": rs.seq_len}


def test_dryrun_knobs_are_the_references(monkeypatch):
    for var, val in (("DRYRUN_SP_DIM", "2"), ("DRYRUN_MOE_PIPELINE", "1"),
                     ("DRYRUN_ATTN_CHUNK", "512")):
        monkeypatch.setenv(var, val)
    sh = dryrun.sharding_for("mixtral-8x22b", "train_4k", True)
    assert (sh.sp_dim, sh.moe_pipeline, sh.attn_chunk) == (2, True, 512)
    assert _ref_dryrun().sharding_for("mixtral-8x22b", "train_4k", True).sp_dim == 2


# ---------------------------------------------------------------------------
# one rank on meta against a real LocalMesh rank
# ---------------------------------------------------------------------------

B, L = 8, 64  # the global batch and sequence of the real-rank cells


def _cfg(row):
    return dataclasses.replace(get_arch(row).reduced(), head_dim=64)


def _storage_bytes(tensors):
    seen = {id(t.untyped_storage()): dryrun.granule_bytes(t.untyped_storage().nbytes())
            for t in tensors}
    return sum(seen.values())


def _real_rank0(cfg, sh, shape, kind):
    """Rank 0 of ``kind``'s program on a CPU LocalMesh of ``shape`` (pods,
    data, model), float32: the bytes it sends by kind under the ring model,
    the flash launches' shapes, and its arguments' storage bytes."""
    pods, data, model_n = shape
    mesh = make_local_mesh(data, model_n, pods=pods, device="cpu")
    model = build_model(cfg, sh, mesh, dtype=torch.float32)
    whole = model.init_fn(torch.Generator().manual_seed(1))
    sent = dict.fromkeys(("all-gather", "all-reduce", "all-to-all", "collective-permute"), 0.0)
    flash, args = [], {}
    lock = threading.Lock()
    name0 = "(0, 0, 0)" if pods > 1 else "(0, 0)"
    orig = {k: getattr(group_mod.LocalGroup, k) for k in ("all_to_all", "all_reduce_sum",
                                                          "all_gather", "shift_start")}

    def rank0():
        return threading.current_thread().name.endswith(name0)

    def nbytes(x):
        return x.numel() * x.element_size()

    def count(kind_, n):
        if rank0():
            sent[kind_] += n

    def a2a(self, chunks):
        count("all-to-all", nbytes(chunks) * (self.size - 1) / self.size)
        return orig["all_to_all"](self, chunks)

    def ar(self, x):
        count("all-reduce", 2 * nbytes(x) * (self.size - 1) / self.size)
        return orig["all_reduce_sum"](self, x)

    def ag(self, x):
        count("all-gather", nbytes(x) * (self.size - 1))
        return orig["all_gather"](self, x)

    def shift(self, x, s):
        if s % self.size:
            count("collective-permute", nbytes(x))
        return orig["shift_start"](self, x, s)

    fa = ops.flash_attention

    def spy_flash(q, k, v, **kw):
        if rank0():
            out = fa(q, k, v, **kw)
            with lock:
                flash.append(work.launch_shapes(q, k, v, out))
            return out
        return fa(q, k, v, **kw)

    toks = torch.randint(0, cfg.vocab_size, (B, L), generator=torch.Generator().manual_seed(2),
                         dtype=torch.int32)

    def program(ctx):
        p = model.shard_params(whole)
        b_loc = row_block(B, batch_groups(model.sharding))[1]
        if kind == "train":
            opt = rank_opt_state(model, p)
            step, _ = make_train_step(model, TrainConfig(opt=AdamWConfig()))
            held = list(p.parameters()) + [*opt["m"].values(), *opt["v"].values()]
            if rank0():
                args["bytes"] = _storage_bytes(held) + dryrun.granule_bytes(b_loc * L * 4)
            step(p, opt, {"tokens": toks})
        elif kind == "prefill":
            rows = model.rank_rows({"tokens": toks})
            if rank0():
                args["bytes"] = _storage_bytes(list(p.parameters()) + [rows["tokens"].clone()])
            model.prefill_fn(p, rows)
        else:
            caches = model.init_caches_fn(B, L)
            tok = model.rank_rows({"tokens": toks[:, :1]})["tokens"].clone()
            if rank0():
                args["bytes"] = _storage_bytes(list(p.parameters()) + [tok] + [
                    t for layer in caches for t in layer.values()])
            model.decode_fn(p, {"tokens": tok, "pos": L - 1, "caches": caches})

    mp = pytest.MonkeyPatch()
    try:
        for k, fn in (("all_to_all", a2a), ("all_reduce_sum", ar), ("all_gather", ag),
                      ("shift_start", shift)):
            mp.setattr(group_mod.LocalGroup, k, fn)
        mp.setattr(ops, "flash_attention", spy_flash)
        mesh.run(program)
    finally:
        mp.undo()
    return sent, flash, args["bytes"]


REAL_CELLS = [
    ("smollm-360m", (1, 2, 2), dict(seq_axis="model"), "train"),
    ("granite-3-8b", (2, 2, 2), dict(fsdp=True, seq_axis="model"), "train"),
    ("phi3.5-moe-42b-a6.6b", (2, 2, 2), dict(fsdp=True), "train"),
    ("qwen1.5-0.5b", (1, 2, 2), {}, "prefill"),
    ("recurrentgemma-2b", (2, 2, 2), dict(attn_anchor=True), "prefill"),
    ("internlm2-1.8b", (2, 2, 2), {}, "decode"),
]


@pytest.mark.parametrize("row,shape,kw,kind", REAL_CELLS,
                         ids=[f"{r}-{'x'.join(map(str, s))}-{k}" for r, s, _, k in REAL_CELLS])
def test_meta_rank_equals_local_mesh_rank0(row, shape, kw, kind):
    cfg = _cfg(row)
    pods = shape[0]
    sh = ShardingConfig(batch_axes=("pod", "data") if pods > 1 else ("data",), **kw)
    mesh = AbstractMesh(shape[1], shape[2], pods=pods)
    meta = dryrun.measure_lm(build_model(cfg, sh, mesh, dtype=torch.float32), kind, B, L)
    sent, flash, arg_bytes = _real_rank0(cfg, sh, shape, kind)
    got = {k: v for k, v in meta["collectives"].items() if k != "ops"}
    assert got == dict(sent, **{"reduce-scatter": 0.0}) and any(got.values())
    assert meta["memory"]["argument_bytes"] == arg_bytes
    assert meta["launches"].get("flash_attention", 0) == len(flash)
    assert sorted(meta["launch_shapes"]) == sorted({str(s) for s in flash})
    assert bool(flash) == (kind == "prefill")
    assert meta["memory"]["temp_bytes"] > 0 and meta["cost"]["flops"] > 0


# ---------------------------------------------------------------------------
# full size
# ---------------------------------------------------------------------------


def _spec_bytes(shapes_specs, sizes, itemsize_of) -> int:
    return sum(dryrun.granule_bytes(math.prod(local_shape(shape, spec, sizes)) * itemsize_of(k))
               for k, (shape, spec) in shapes_specs.items())


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16", "2x16x16"])
def test_smollm_full_size_cells(multi_pod):
    row = "smollm-360m"
    for shape_name, shape in SHAPES.items():
        if dryrun.skip_reason(row, shape_name):
            rec = dryrun.run_cell(row, shape_name, multi_pod)
            assert rec["status"] == "skipped" and shape_name == "long_500k"
            continue
        model, _, meta = dryrun.lm_cell(row, shape_name, multi_pod)
        if shape.kind == "train":  # full width, two layers (the full depth takes ~40 s)
            model = build_model(dataclasses.replace(model.cfg, num_layers=2), model.sharding,
                                model.mesh)
        rec = dryrun.measure_lm(model, shape.kind, shape.global_batch, shape.seq_len)
        sizes = mesh_axes(model.mesh, model.sharding)
        shapes = dict(model.abstract_params().named_parameters())
        pspecs = model.param_specs(shapes)
        want = _spec_bytes({k: (t.shape, pspecs[k]) for k, t in shapes.items()}, sizes,
                           lambda k: 4)
        structs, specs = model.input_specs(shape)
        if shape.kind == "train":
            _, ospecs = _specs(model)
            want += 2 * _spec_bytes({k: (t.shape, ospecs["m"][k]) for k, t in shapes.items()},
                                    sizes, lambda k: 4)
        if shape.kind == "decode":
            caches = structs.pop("caches")
            cspecs = specs.pop("caches")
            want += sum(_spec_bytes({k: (t.shape, cs[k]) for k, t in layer.items()}, sizes,
                                    lambda k, layer=layer: layer[k].element_size())
                        for layer, cs in zip(caches, cspecs))
            structs.pop("pos")
        want += _spec_bytes({k: (t.shape, specs[k]) for k, t in structs.items()}, sizes,
                            lambda k: structs[k].element_size())
        assert rec["memory"]["argument_bytes"] == want, shape_name
        meta["params"] = meta["active_params"] = model.cfg.params_count()
        terms = analysis.analyze_record(dict(meta, status="ok", **rec), hbm_bytes=80e9)
        assert rec["cost"]["flops"] * meta["chips"] >= terms.model_flops > 0, shape_name
        assert terms.fits and terms.dominant in ("compute", "memory", "collective")
        if shape.kind == "prefill":
            assert rec["launches"] == {"flash_attention": model.cfg.num_layers}


def test_roofline_reads_lm_records(tmp_path):
    rec = dryrun.run_cell("whisper-base", "decode_32k", True, str(tmp_path))
    assert rec["status"] == "ok" and rec["cost_raw"] == rec["cost"] and "probe" not in rec
    assert rec["memory"]["alias_bytes"] > 0 and rec["collectives"]["ops"]["all-gather"] > 0
    (t,) = analysis.analyze_dir(str(tmp_path), hbm_bytes=80e9)
    assert (t.arch, t.shape, t.mesh, t.chips) == ("whisper-base", "decode_32k", "2x16x16", 512)
    assert t.fits and t.model_flops == 2 * rec["active_params"] * 128
    assert "whisper-base" in analysis.format_table([t])
    assert np.isfinite(t.step_s) and t.step_s > 0


def test_production_lm_view():
    counting = make_production_mesh(multi_pod=True)
    lm = counting.lm_view()
    assert (counting.pod_size, counting.data_size, counting.iter_size) == (1, 16, 32)
    assert (lm.pod_size, lm.data_size, lm.iter_size) == (2, 16, 16)
    assert lm.axis_names == counting.axis_names and lm.shape == counting.shape
    single = make_production_mesh()
    assert single.lm_view() is single
    got = lm.run(lambda ctx: (ctx.pod.size, ctx.data.size, ctx.model.size))
    assert got == [(2, 16, 16)]
