"""The port's sharding specs == the reference's, exactly, for all ten rows.

``param_pspecs``, ``cache_pspecs``, ``opt_state_pspecs`` and
``Model.input_specs`` at full size (shapes only: the reference through
``jax.eval_shape``, the port on ``meta``) and at the reduced configs, with
FSDP off and on.  The reference stacks each pattern position over depth;
the port keeps one module per layer, so a stacked reference leaf maps onto
one port weight per layer, its spec less the leading ``None``.  Specs are
compared as plain tuples.  Also: every row builds on a mesh with a pod
axis, and a sequence axis other than the model axis is refused; every
row, ``seq_axis="model"`` and ``attn_anchor`` build on a mesh; the
launcher's production mesh flags build the reference's sharding.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_arch as ref_get_arch
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import ShardingConfig as RefShardingConfig
from repro.models import build_model as ref_build_model
from repro.models.factory import cache_pspecs as ref_cache_pspecs
from repro.models.factory import param_pspecs as ref_param_pspecs
from repro.models.transformer import init_caches as ref_init_caches
from repro.models.transformer import init_params as ref_init_params
from repro.models.transformer import layer_plan
from repro.train.optimizer import opt_state_pspecs as ref_opt_state_pspecs
from repro_torch.configs import ARCHS, SHAPES, ShardingConfig, get_arch
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.factory import cache_pspecs, param_pspecs
from repro_torch.train.optimizer import opt_state_pspecs

ROWS = list(ARCHS)
META = torch.device("meta")


def _is_spec(x):
    return isinstance(x, JP)


def _path(path) -> list:
    return [str(getattr(e, "key", getattr(e, "idx", e))) for e in path]


def _port_leaves(tree, cfg, *, is_leaf=None) -> dict:
    """A reference tree shaped like the weights (or caches) as ``{port name:
    (leaf, stacked)}``: ``groups/pos{j}`` leaves map onto one port layer per
    group (``stacked`` True: the leaf's first dimension is the group's),
    ``tail/{i}`` onto the layers after them, ``encoder/...`` as they are."""
    n_full, pat, _ = layer_plan(cfg)
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]:
        parts = _path(path)
        if parts[0] == "groups":
            j = int(parts[1][3:])
            for gi in range(n_full):
                out[".".join(["blocks", str(gi * len(pat) + j)] + parts[2:])] = (leaf, True)
        elif parts[0] == "tail":
            out[".".join(["blocks", str(n_full * len(pat) + int(parts[1]))] + parts[2:])] = \
                (leaf, False)
        else:
            out[".".join(parts)] = (leaf, False)
    return out


def _unstacked(spec, stacked: bool) -> tuple:
    return tuple(spec)[1:] if stacked else tuple(spec)


def _configs(name: str, size: str):
    rcfg, cfg = ref_get_arch(name), get_arch(name)
    return (rcfg.reduced(), cfg.reduced()) if size == "reduced" else (rcfg, cfg)


_REF_SHAPES = {}


def _ref_shapes(name: str, size: str):
    key = (name, size)
    if key not in _REF_SHAPES:
        rcfg, _ = _configs(name, size)
        _REF_SHAPES[key] = jax.eval_shape(lambda k: ref_init_params(rcfg, k), jax.random.key(0))
    return _REF_SHAPES[key]


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", ROWS)
def test_param_pspecs_equal_the_reference(name, size, fsdp):
    rcfg, cfg = _configs(name, size)
    shapes = _ref_shapes(name, size)
    want = _port_leaves(ref_param_pspecs(shapes, rcfg, RefShardingConfig(fsdp=fsdp)), rcfg,
                        is_leaf=_is_spec)
    ref_shapes = _port_leaves(shapes, rcfg)
    model = build_model(cfg, ShardingConfig(fsdp=fsdp), device="cpu")
    params = model.abstract_params()
    assert {p.device.type for p in params.parameters()} == {"meta"}
    got = model.param_specs(params)
    assert sorted(got) == sorted(want)
    for k, spec in got.items():
        spec_r, stacked = want[k]
        assert tuple(spec) == _unstacked(spec_r, stacked), k
        leaf, stacked = ref_shapes[k]
        assert tuple(dict(params.named_parameters())[k].shape) == \
            _unstacked(leaf.shape, stacked), k
    assert param_pspecs(dict(params.named_parameters()), cfg, ShardingConfig(fsdp=fsdp)) == got


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("name", ROWS)
def test_cache_pspecs_equal_the_reference(name, size):
    rcfg, cfg = _configs(name, size)
    b, s = 8, 64
    shapes = jax.eval_shape(lambda: ref_init_caches(rcfg, b, s))
    sh = dict(batch_axes=("data",), model_axis="model")
    want = _port_leaves(ref_cache_pspecs(shapes, rcfg, RefShardingConfig(**sh)), rcfg,
                        is_leaf=_is_spec)
    ref_leaves = _port_leaves(shapes, rcfg)
    model = build_model(cfg, ShardingConfig(**sh), device="cpu")
    from repro_torch.models.transformer import init_caches

    caches = init_caches(cfg, b, s, device=META)
    got = cache_pspecs(caches, cfg, ShardingConfig(**sh))
    assert got == model.cache_specs(caches)
    n = 0
    for i, layer in enumerate(got):
        for k, spec in layer.items():
            spec_r, stacked = want[f"blocks.{i}.{k}"]
            assert tuple(spec) == _unstacked(spec_r, stacked), (i, k)
            leaf, stacked = ref_leaves[f"blocks.{i}.{k}"]
            assert tuple(caches[i][k].shape) == _unstacked(leaf.shape, stacked), (i, k)
            n += 1
    assert n == len(want)


def _elements(shape, spec, sizes) -> int:
    n = 1
    for d, part in zip(shape, tuple(spec) + (None,) * len(shape)):
        k = 1
        for a in ((part,) if isinstance(part, str) else part or ()):
            k *= sizes.get(a, 1)
        n *= d // k
    return n


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp", "fsdp"])
@pytest.mark.parametrize("name", ROWS)
def test_opt_state_pspecs_equal_the_reference(name, fsdp):
    """ZeRO-1 at ``data_size = 16``.  The rule is the reference's, on the
    port's weights: the port's specs == the reference's function applied
    to the port's weight specs and shapes, exactly.  Against the
    reference's own stacked state: where it leaves the layer stack whole,
    the specs are equal less the stacked dimension.  Where the stack's depth
    divides the data axis, the reference shards the layer stack itself
    (each data rank holds whole layers' state); the port, with no stack,
    shards the leaf's own first free dimension, and each rank holds as many
    elements of state as the reference's."""
    rcfg, cfg = _configs(name, "full")
    shapes = _ref_shapes(name, "full")
    rspecs = ref_param_pspecs(shapes, rcfg, RefShardingConfig(fsdp=fsdp))
    want = ref_opt_state_pspecs(rspecs, shapes, zero1=True, data_size=16)
    params = build_model(cfg, ShardingConfig(fsdp=fsdp), device="cpu").abstract_params()
    shp = dict(params.named_parameters())
    pspecs = param_pspecs(params, cfg, ShardingConfig(fsdp=fsdp))
    got = opt_state_pspecs(pspecs, shp, zero1=True, data_size=16)
    assert tuple(got["step"]) == tuple(want["step"]) == ()
    same_rule = ref_opt_state_pspecs({k: JP(*s) for k, s in pspecs.items()},
                                     {k: jax.ShapeDtypeStruct(tuple(t.shape), np.float32)
                                      for k, t in shp.items()}, zero1=True, data_size=16)
    sizes = {"data": 16, "model": 16}
    for kind in ("m", "v"):
        assert {k: tuple(s) for k, s in got[kind].items()} == \
            {k: tuple(s) for k, s in same_rule[kind].items()}
        w = _port_leaves(want[kind], rcfg, is_leaf=_is_spec)
        ref_leaves = _port_leaves(shapes, rcfg)
        assert sorted(w) == sorted(got[kind])
        mine = theirs = 0
        for k, spec in got[kind].items():
            spec_r, stacked = w[k]
            if not (stacked and spec_r[0] is not None):
                assert tuple(spec) == _unstacked(spec_r, stacked), (kind, k)
            mine += _elements(tuple(shp[k].shape), spec, sizes)
            leaf, stacked = ref_leaves[k]
            # a stacked leaf's rank share, spread over its layers
            theirs += _elements(tuple(leaf.shape), spec_r, sizes) / (leaf.shape[0] if stacked
                                                                      else 1)
        assert mine == theirs
    # without zero1 the state inherits the weights' specs
    plain = opt_state_pspecs(pspecs, shp, zero1=False, data_size=16)
    assert plain["m"] == pspecs


def _flat_specs(tree) -> list:
    return [(tuple(_path(p)), tuple(s)) for p, s in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_spec)[0]]


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ROWS)
def test_input_specs_equal_the_reference(name, shape):
    rcfg, cfg = _configs(name, "full")
    sh = dict(batch_axes=("data",))
    rstructs, rspecs = ref_build_model(rcfg, RefShardingConfig(**sh)).input_specs(
        REF_SHAPES[shape])
    structs, specs = build_model(cfg, ShardingConfig(**sh), device="cpu").input_specs(
        SHAPES[shape])
    assert sorted(structs) == sorted(rstructs) and sorted(specs) == sorted(rspecs)
    for k in structs:
        if k == "caches":
            want = _port_leaves(rstructs[k], rcfg)
            want_specs = _port_leaves(rspecs[k], rcfg, is_leaf=_is_spec)
            for i, layer in enumerate(structs[k]):
                for c, t in layer.items():
                    leaf, stacked = want[f"blocks.{i}.{c}"]
                    assert t.device == META
                    assert tuple(t.shape) == _unstacked(leaf.shape, stacked)
                    assert str(t.dtype).split(".")[-1] == str(np.dtype(leaf.dtype)) or \
                        (t.dtype == torch.bfloat16 and str(leaf.dtype) == "bfloat16")
                    assert tuple(specs[k][i][c]) == _unstacked(*want_specs[f"blocks.{i}.{c}"])
            continue
        assert structs[k].device == META
        assert tuple(structs[k].shape) == tuple(rstructs[k].shape), k
        assert str(structs[k].dtype).split(".")[-1] == str(rstructs[k].dtype), k
        assert tuple(specs[k]) == tuple(rspecs[k]), k


def test_sharding_config_carries_the_reference_fields():
    from repro.configs.base import ShardingConfig as R

    assert [f.name for f in dataclasses.fields(ShardingConfig)] == \
        [f.name for f in dataclasses.fields(R)]
    assert dataclasses.asdict(ShardingConfig()) == dataclasses.asdict(R())


WAITING = [n for n in ROWS if get_arch(n).block_pattern != ("attn",)]


@pytest.mark.parametrize("name", WAITING)
def test_a_mesh_refuses_the_rows_that_wait(name):
    """The four rows with other block kinds build on a mesh, a pod axis
    too; what a mesh refuses is a sequence axis other than the model axis
    (the reference's callers name no other)."""
    cfg = get_arch(name).reduced()
    build_model(cfg, ShardingConfig(batch_axes=("data",)), make_local_mesh(2, 2, device="cpu"))
    pod = make_local_mesh(1, 2, pods=2, device="cpu")
    model = build_model(cfg, ShardingConfig(batch_axes=("pod", "data"), seq_axis="model"), pod)
    assert model.mesh is pod and pod.size == 4
    with pytest.raises(ValueError, match="model axis"):
        build_model(cfg, ShardingConfig(batch_axes=("data",), seq_axis="pod"), pod)


@pytest.mark.parametrize("field", [{"seq_axis": "model"}, {"attn_anchor": True}],
                         ids=["seq_axis", "attn_anchor"])
def test_a_mesh_refuses_sequence_parallelism_and_anchors(field):
    """Sequence parallelism over the model axis and anchors build on a mesh
    now; a sequence axis other than the model axis, or an ``sp_dim`` other
    than 1 or 2, is refused."""
    mesh = make_local_mesh(1, 2, device="cpu")
    cfg = get_arch("smollm-360m").reduced()
    build_model(cfg, ShardingConfig(batch_axes=("data",), **field), mesh)
    with pytest.raises(ValueError, match="model axis"):
        build_model(cfg, ShardingConfig(batch_axes=("data",), **dict(field, seq_axis="data")),
                    mesh)
    with pytest.raises(ValueError, match="sp_dim"):
        build_model(cfg, ShardingConfig(batch_axes=("data",), sp_dim=3, **field), mesh)


@pytest.mark.parametrize("flags", [["--production-mesh"], ["--multi-pod"]])
def test_launcher_refuses_the_production_mesh(flags, monkeypatch):
    """``--production-mesh`` builds the reference's ShardingConfig on the
    production mesh's shape (here made small: ``launch.mesh.PRODUCTION_AXES``
    is where every reader takes it from); ``--multi-pod`` alone does
    nothing, as in the reference."""
    from repro_torch.launch import mesh as launch_mesh

    monkeypatch.setitem(launch_mesh.PRODUCTION_AXES, False, (("data", 2), ("model", 2)))
    got = {}
    monkeypatch.setattr(launch_train, "train",
                        lambda model, tcfg, mesh: got.update(model=model, mesh=mesh))
    launch_train.main(["--arch", "smollm-360m", "--steps", "1", "--device", "cpu"] + flags)
    if flags == ["--multi-pod"]:
        assert got["mesh"] is None
        return
    mesh, sh = got["mesh"], got["model"].sharding
    assert (mesh.pod_size, mesh.data_size, mesh.iter_size) == (1, 2, 2) and mesh.turns
    want = RefShardingConfig(batch_axes=("data",), fsdp=False, seq_axis="model")
    assert dataclasses.asdict(sh) == dataclasses.asdict(want)
