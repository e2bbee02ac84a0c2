"""The four rows whose blocks are not ``("attn",)`` on a ``data x model``
mesh of thread ranks, float32: llama-3.2-vision-90b (``cross``),
whisper-base (``attn`` and ``cross`` over its encoder), rwkv6-3b
(``rwkv``) and recurrentgemma-2b (``rglru`` and ``local``).

Against the reference's meshed run (one subprocess on 8 forced host
devices, biases and cross gates drawn nonzero): each row on 2 x 2 with its
prefill and decode, rwkv6-3b on 1 x 4 (one head a rank), recurrentgemma-2b
on 2 x 2 with ``attn_anchor`` (4 q heads, 1 KV head: each rank attends its
2 q heads over the one KV head).  The loss within 1e-5 relative, every
gradient leaf, gathered whole, within 1e-4 of its largest entry, the
prefill's logits within 1e-4 and each decode step's within 2e-4 (bf16
self-attention caches on both sides).  Against one device: every row on
1 x 4 and 4 x 1 (float32 caches; logits within 1e-4).  Each rank
holds exactly its specs' share of the weights and of the caches (the rwkv
``wkv`` state as ``H / model`` whole heads, the elements the spec's ``dv /
model`` gives), and the launcher trains rwkv6-3b on 2 x 2 with the losses
of one device.  The ``attn_cross`` block (whisper's config on a made-up
pattern) on 2 x 2 == one device, with and without sequence parallelism.
"""

from __future__ import annotations

import math
import re

import pytest
import torch

from _mesh_rows import (
    assert_leaves_close,
    assert_logits_close,
    config,
    context,
    job,
    port_mesh_run,
    port_single_run,
    reference_runs,
    tokens,
)
from _train_rows import one_thread  # noqa: F401
from repro_torch.comm.spec import local_shape
from repro_torch.configs import ShardingConfig
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.models.factory import context_len, mesh_axes

ROWS = ["llama-3.2-vision-90b", "whisper-base", "rwkv6-3b", "recurrentgemma-2b"]
SHORT = {"llama-3.2-vision-90b": "vision", "whisper-base": "whisper", "rwkv6-3b": "rwkv",
         "recurrentgemma-2b": "rglru"}
MESHES = [(1, 4), (4, 1)]  # 2 x 2 is held against the reference

# dealt to 4 processes in turn: the vision row (the slowest to compile) alone
# the reference's anchored prefill fails where it repeats the KV heads (its
# cache buffer has the KV heads' count, the repeated keys the q heads'):
# the anchored job holds the loss and gradients, one device the serving
JOBS = [job(f"{SHORT[row]}-2x2", row, 2, 2, serve=True, perturb=True)
        for row in ("whisper-base", "rwkv6-3b", "llama-3.2-vision-90b", "recurrentgemma-2b")]
JOBS += [job("rwkv-1x4", "rwkv6-3b", 1, 4, serve=True, perturb=True),
         job("rglru-2x2-anchor", "recurrentgemma-2b", 2, 2, perturb=True, attn_anchor=True)]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(JOBS, tmp_path_factory.mktemp("mesh_rows"), procs=4)


def _weights(cfg):
    """The port's reduced weights, the cross gates drawn nonzero (zero at
    init, a cross block would pass nothing to the loss)."""
    p = build_model(cfg, device="cpu", dtype=torch.float32).init_fn(
        torch.Generator().manual_seed(0))
    for name, w in p.named_parameters():
        if name.endswith("xgate"):
            w.data.fill_(0.5)
    return p


@pytest.mark.parametrize("j", JOBS, ids=lambda j: j["id"])
def test_rows_equal_the_reference_mesh(reference, j):
    ref = reference[j["id"]]
    cfg = config(j["row"], j["heads"])
    loss, grads, logits = port_mesh_run(cfg, ref["params"], tokens(cfg.vocab_size), j["data"],
                                        j["model"], serve=bool(j["serve"]), ctx=context(cfg),
                                        **j["sharding"])
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert_leaves_close(grads, ref["grads"])
    if j["serve"]:
        assert_logits_close(logits[:1], ref["logits"][:1])
        assert_logits_close(logits[1:], ref["logits"][1:], tol=2e-4)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("row", ROWS)
def test_rows_equal_one_device(row, shape):
    cfg = config(row)
    params = _weights(cfg)
    toks, ctx = tokens(cfg.vocab_size), context(cfg)
    loss, grads, logits = port_single_run(cfg, params, toks, serve=True,
                                          cache_dtype=torch.float32, ctx=ctx)
    got_loss, got_grads, got_logits = port_mesh_run(cfg, params, toks, *shape,
                                                    fsdp=shape[0] > 1, serve=True,
                                                    cache_dtype=torch.float32, ctx=ctx)
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    assert_leaves_close(got_grads, grads)
    assert_logits_close(got_logits, logits)


def _elements(shape_, spec, sizes) -> int:
    return math.prod(local_shape(shape_, spec, sizes))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("row", ROWS)
def test_each_rank_holds_its_specs_share(row, shape):
    """Each weight a rank holds has its spec's local shape (FSDP on); each
    cache and state of ``init_caches_fn`` has its spec's element count (its
    spec's local shape, but for the rwkv ``wkv`` state: whole heads)."""
    cfg = config(row)
    mesh = make_local_mesh(*shape, device="cpu")
    model = build_model(cfg, ShardingConfig(batch_axes=("data",), fsdp=True), mesh,
                        dtype=torch.float32)
    whole = _weights(cfg)
    sizes = mesh_axes(mesh, model.sharding)
    abstract = dict(model.abstract_params().named_parameters())
    specs = model.param_specs(abstract)
    ctx_len, _ = context_len(cfg)
    b, s = 4, 24
    full_caches = build_model(cfg, device="cpu").init_caches_fn(b, s, ctx_len)
    cspecs = model.cache_specs(full_caches)

    def rank(ctx):
        p = model.shard_params(whole)
        for k, t in p.named_parameters():
            assert tuple(t.shape) == local_shape(abstract[k].shape, specs[k], sizes), k
        caches = model.init_caches_fn(b, s, ctx_len)
        for i, (layer, full, spec) in enumerate(zip(caches, full_caches, cspecs)):
            assert sorted(layer) == sorted(full)
            for k, t in layer.items():
                want = local_shape(full[k].shape, spec[k], sizes)
                if k == "wkv":
                    assert t.numel() == math.prod(want), (i, k)
                    assert t.shape[1] == cfg.d_model // cfg.resolved_head_dim // shape[1]
                else:
                    assert tuple(t.shape) == want, (i, k, tuple(t.shape), want)
        return True

    assert all(mesh.run(rank))


def test_launcher_trains_rwkv_on_a_2x2_mesh(capsys):
    """``--data 2 --model 2`` on rwkv6-3b (bf16 compute) logs the losses of
    ``--data 1`` within the bf16 rule of 1e-3 relative."""
    args = ["--arch", "rwkv6-3b", "--steps", "10", "--device", "cpu"]
    launch_train.main(args)
    one = _losses(capsys.readouterr().out.splitlines())
    launch_train.main(args + ["--data", "2", "--model", "2"])
    mesh = _losses(capsys.readouterr().out.splitlines())
    assert len(one) == len(mesh) == 1
    assert all(abs(a - b) <= 1e-3 * a for a, b in zip(one, mesh))


def _losses(logs):
    return [float(re.search(r"loss ([0-9.]+)", s).group(1)) for s in logs if "loss" in s]


@pytest.mark.parametrize("sharding", [{}, {"seq_axis": "model"}], ids=["replicated", "sp1"])
def test_attn_cross_equals_one_device(sharding):
    """whisper-base's reduced config on a made-up pattern of ``attn_cross``
    blocks (self-attention, cross-attention and an FFN in one block) on
    2 x 2: its sequence-sharded KV cache beside the context's whole keys
    and values, with and without sequence parallelism."""
    import dataclasses

    cfg = dataclasses.replace(config("whisper-base"), block_pattern=("attn_cross",))
    params = _weights(cfg)
    toks, ctx = tokens(cfg.vocab_size), context(cfg)
    loss, grads, logits = port_single_run(cfg, params, toks, serve=True,
                                          cache_dtype=torch.float32, ctx=ctx)
    got_loss, got_grads, got_logits = port_mesh_run(cfg, params, toks, 2, 2, serve=True,
                                                    cache_dtype=torch.float32, ctx=ctx,
                                                    **sharding)
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    assert_leaves_close(got_grads, grads)
    assert_logits_close(got_logits, logits)
