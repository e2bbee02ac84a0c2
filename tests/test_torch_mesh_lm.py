"""The dense attention rows on a ``data x model`` mesh of thread ranks, float32.

On meshes 2 x 2, 1 x 4 and 4 x 1 the meshed loss equals the port's
single-device loss within 1e-5 relative and every gradient leaf, gathered
whole, within 1e-4 of the leaf's largest entry; the prefill's and each
decode step's logits (a float32 cache) likewise.  On 2 x 2 (FSDP on for
two of the rows) the same holds against the reference's own meshed run
(``jax.value_and_grad`` of its ``loss_fn``, its prefill, its decode over
its bf16 cache against the port's bf16 cache), computed once in one
subprocess.  A cut-head case: both packages' reduced smollm config at 6
heads and 3 KV heads on 1 x 4, where a rank's columns hold 1.5 heads and
0.75 of a KV head.
"""

from __future__ import annotations

import pytest
import torch

from _mesh_rows import (
    DENSE,
    assert_leaves_close,
    assert_logits_close,
    config,
    job,
    port_mesh_run,
    port_single_run,
    reference_runs,
    tokens,
)
from _train_rows import one_thread  # noqa: F401
from repro_torch.models import build_model

MESHES = [(2, 2), (1, 4), (4, 1)]
CUT = (6, 3)

JOBS = [job(f"{row}-2x2", row, 2, 2, fsdp=row in ("smollm-360m", "internlm2-1.8b"),
            serve=row == "smollm-360m") for row in DENSE]
JOBS.append(job("cut-1x4", "smollm-360m", 1, 4, serve=True, heads=CUT))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(JOBS, tmp_path_factory.mktemp("mesh_lm"))


def _weights(cfg):
    return build_model(cfg, device="cpu", dtype=torch.float32).init_fn(
        torch.Generator().manual_seed(0))


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("row", DENSE)
def test_dense_rows_equal_one_device(row, shape):
    cfg = config(row)
    params = _weights(cfg)
    toks = tokens(cfg.vocab_size)
    loss, grads, logits = port_single_run(cfg, params, toks, serve=True,
                                          cache_dtype=torch.float32)
    got_loss, got_grads, got_logits = port_mesh_run(cfg, params, toks, *shape,
                                                    fsdp=shape[0] > 1, serve=True,
                                                    cache_dtype=torch.float32)
    assert abs(got_loss - loss) <= 1e-5 * abs(loss)
    assert_leaves_close(got_grads, grads)
    assert_logits_close(got_logits, logits)


@pytest.mark.parametrize("j", JOBS, ids=lambda j: j["id"])
def test_dense_rows_equal_the_reference_mesh(reference, j):
    ref = reference[j["id"]]
    cfg = config(j["row"], j["heads"])
    loss, grads, logits = port_mesh_run(cfg, ref["params"], tokens(cfg.vocab_size), j["data"],
                                        j["model"], fsdp=j["fsdp"], serve=bool(j["serve"]))
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert_leaves_close(grads, ref["grads"])
    if j["serve"]:
        # bf16 caches on both sides: a key or value that rounds to the next
        # bf16 step on one side moves a logit by up to 2^-8 of its share
        assert_logits_close(logits[:1], ref["logits"][:1])
        assert_logits_close(logits[1:], ref["logits"][1:], tol=2e-4)


def test_cut_heads_equal_one_device():
    """6 heads, 3 KV heads at ``model = 4``: every rank gathers q, k and v
    and keeps its own output columns; 4 x 1 and 2 x 2 on the same weights."""
    cfg = config("smollm-360m", CUT)
    params = _weights(cfg)
    toks = tokens(cfg.vocab_size)
    loss, grads, logits = port_single_run(cfg, params, toks, serve=True,
                                          cache_dtype=torch.float32)
    for shape in ((1, 4), (2, 2)):
        got_loss, got_grads, got_logits = port_mesh_run(cfg, params, toks, *shape, serve=True,
                                                        cache_dtype=torch.float32)
        assert abs(got_loss - loss) <= 1e-5 * abs(loss)
        assert_leaves_close(got_grads, grads)
        assert_logits_close(got_logits, logits)
