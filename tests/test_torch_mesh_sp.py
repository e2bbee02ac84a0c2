"""Sequence parallelism (``seq_axis="model"``, ``sp_dim`` 1 and 2) and head
anchors (``attn_anchor``) on a ``data x model`` mesh of thread ranks,
float32.

Against the reference's meshed run (one subprocess on 8 forced host
devices): smollm-360m with ``sp_dim=1`` on 2 x 2 with FSDP, with its
prefill and decode; phi3.5-moe with ``sp_dim=1`` on 2 x 2 (the experts on
the whole stream, each rank keeping its block of their output);
recurrentgemma-2b with ``sp_dim=2`` on 1 x 4; smollm-360m at 4 heads and 2
KV heads on 1 x 4 with ``attn_anchor`` (each rank attends its one q head
over the KV head it reads; the reference's anchored prefill fails where it
repeats KV heads, so that job holds the loss and gradients).  Tolerances
as tests/test_torch_mesh_lm.py's.  Against one device: the five rows with
no experts under ``sp_dim=1`` on 2 x 2 and ``sp_dim=2`` on 1 x 4, the
anchored cases (recurrentgemma on 2 x 2 and 1 x 4, smollm at 4 and 2 heads
on 1 x 4, the vision row's cross-attention at 4 and 1 heads on 2 x 2,
whisper at 4 and 2 heads on 1 x 4 under ``sp_dim=2``), and a prompt whose
length the model axis does not divide (padded and masked).  Between blocks
a rank holds ``1 / model`` of the stream.
"""

from __future__ import annotations

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
from repro_torch.comm.spec import PartitionSpec as P
from repro_torch.comm.spec import gather_whole
from repro_torch.configs import ShardingConfig
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model

SP = {"seq_axis": "model"}
JOBS = [
    job("smollm-sp1-2x2-fsdp", "smollm-360m", 2, 2, fsdp=True, serve=True, **SP),
    job("phi-sp1-2x2", "phi3.5-moe-42b-a6.6b", 2, 2, **SP),
    job("rglru-sp2-1x4", "recurrentgemma-2b", 1, 4, perturb=True, sp_dim=2, **SP),
    job("dense-anchor-1x4", "smollm-360m", 1, 4, heads=(4, 2), attn_anchor=True),
]
ROWS = ["smollm-360m", "llama-3.2-vision-90b", "whisper-base", "rwkv6-3b", "recurrentgemma-2b"]
ANCHORED = [("recurrentgemma-2b", (2, 2), None, {}), ("recurrentgemma-2b", (1, 4), None, {}),
            ("smollm-360m", (1, 4), (4, 2), {}), ("llama-3.2-vision-90b", (2, 2), (4, 1), {}),
            ("whisper-base", (1, 4), (4, 2), {"sp_dim": 2, **SP})]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(JOBS, tmp_path_factory.mktemp("mesh_sp"), procs=4)


def _weights(cfg):
    p = build_model(cfg, device="cpu", dtype=torch.float32).init_fn(
        torch.Generator().manual_seed(0))
    for name, w in p.named_parameters():
        if name.endswith("xgate"):
            w.data.fill_(0.5)
    return p


@pytest.mark.parametrize("j", JOBS, ids=lambda j: j["id"])
def test_sp_and_anchors_equal_the_reference_mesh(reference, j):
    ref = reference[j["id"]]
    cfg = config(j["row"], j["heads"])
    loss, grads, logits = port_mesh_run(cfg, ref["params"], tokens(cfg.vocab_size), j["data"],
                                        j["model"], fsdp=j["fsdp"], serve=bool(j["serve"]),
                                        ctx=context(cfg), **j["sharding"])
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert_leaves_close(grads, ref["grads"])
    if j["serve"]:
        assert_logits_close(logits[:1], ref["logits"][:1])
        assert_logits_close(logits[1:], ref["logits"][1:], tol=2e-4)


def _equal_one_device(row, shape, heads=None, **sharding):
    cfg = config(row, heads)
    params = _weights(cfg)
    toks, ctx = tokens(cfg.vocab_size), context(cfg)
    loss, grads, logits = port_single_run(cfg, params, toks, serve=True,
                                          cache_dtype=torch.float32, ctx=ctx)
    got_loss, got_grads, got_logits = port_mesh_run(cfg, params, toks, *shape,
                                                    fsdp=shape[0] > 1, serve=True,
                                                    cache_dtype=torch.float32, ctx=ctx,
                                                    **sharding)
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    assert_leaves_close(got_grads, grads)
    assert_logits_close(got_logits, logits)


@pytest.mark.parametrize("sp_dim,shape", [(1, (2, 2)), (2, (1, 4))], ids=["sp1-2x2", "sp2-1x4"])
@pytest.mark.parametrize("row", ROWS)
def test_sequence_parallel_equals_one_device(row, sp_dim, shape):
    _equal_one_device(row, shape, sp_dim=sp_dim, **SP)


@pytest.mark.parametrize("row,shape,heads,sharding", ANCHORED,
                         ids=[f"{r}-{s[0]}x{s[1]}" for r, s, *_ in ANCHORED])
def test_anchored_heads_equal_one_device(row, shape, heads, sharding):
    _equal_one_device(row, shape, heads, attn_anchor=True, **sharding)


@pytest.mark.parametrize("row", ["smollm-360m", "recurrentgemma-2b"])
def test_a_ragged_prompt_pads_the_stream(row):
    """``sp_dim=1`` on 1 x 4 over 22 tokens (the loss) and a prompt of 19:
    the stream pads to 24 and 20 positions, and the loss, the gradients and
    the prefill's logits equal one device's; between blocks each rank holds
    its block of the padded sequence."""
    cfg = config(row)
    params = _weights(cfg)
    toks = torch.as_tensor(tokens(cfg.vocab_size))[:, :22]
    single = build_model(cfg, device="cpu", dtype=torch.float32)
    params.requires_grad_(True)
    loss32 = single.loss_fn(params, {"tokens": toks})
    want_grads = torch.autograd.grad(loss32, list(params.parameters()))
    want = float(loss32.detach())
    params.requires_grad_(False)
    want_logits, _ = single.prefill_fn(params, {"tokens": toks[:, :19]})
    mesh = make_local_mesh(1, 4, device="cpu")
    model = build_model(cfg, ShardingConfig(batch_axes=("data",), **SP), mesh,
                        dtype=torch.float32)

    def rank(ctx):
        p = model.shard_params(params)
        groups = {"data": ctx.data, "model": ctx.model}
        specs = model.param_specs(p)
        h, _, _ = p(toks[:, :19], mode="train", dtype=torch.float32, return_hidden=True,
                    rs=model.rank_shard())
        p.requires_grad_(True)
        loss = model.loss_fn(p, {"tokens": toks})
        grads = [gather_whole(g, specs[k], groups) for (k, _), g in
                 zip(p.named_parameters(), torch.autograd.grad(loss, list(p.parameters())))]
        p.requires_grad_(False)
        lg, _ = model.prefill_fn(p, {"tokens": toks[:, :19]})
        logits = gather_whole(lg, P("data", "model"), groups)
        return tuple(h.shape), float(loss.detach()), grads, logits

    for shape_, loss, grads, logits in mesh.run(rank):
        assert shape_ == (toks.shape[0], 5, cfg.d_model)
        assert abs(loss - want) <= 1e-5 * abs(want)
        assert_leaves_close(dict(enumerate(grads)), dict(enumerate(want_grads)))
        assert_logits_close([logits], [want_logits])


def test_the_stream_splits_its_channels_with_sp_dim_2():
    """``sp_dim=2`` on 1 x 4: between blocks a rank holds ``[B, L, d / 4]``."""
    cfg = config("rwkv6-3b")
    params = _weights(cfg)
    toks = torch.as_tensor(tokens(cfg.vocab_size))
    mesh = make_local_mesh(1, 4, device="cpu")
    model = build_model(cfg, ShardingConfig(batch_axes=("data",), sp_dim=2, **SP), mesh,
                        dtype=torch.float32)

    def rank(ctx):
        h, _, _ = model.shard_params(params)(toks, mode="train", dtype=torch.float32,
                                             return_hidden=True, rs=model.rank_shard())
        return tuple(h.shape)

    assert mesh.run(rank) == [(toks.shape[0], toks.shape[1], cfg.d_model // 4)] * 4
