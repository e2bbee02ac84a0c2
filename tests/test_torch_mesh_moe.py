"""The expert rows on a ``data x model`` mesh == the reference's meshed run.

``moe_block_manual`` routes each data shard's tokens with that shard's own
capacity (and, under EP, each model rank its own slice of them), so other
tokens drop than on one device: an expert row on a mesh is held against
the reference's meshed run on the same mesh, float32, loss within 1e-5
relative and each gradient leaf, gathered whole, within 1e-4 of its
largest entry.  phi3.5-moe (EP: experts over ``model``) with FSDP, fused
and pipelined (``grouped_exchange``), at capacity factor 0.5 so tokens
drop, and its prefill and decode; mixtral (TP: the expert hidden dimension
over ``model``) with FSDP and its prefill and decode; both on 1 x 4 without
FSDP.  The reference runs once, in one subprocess on 8 forced host devices.
"""

from __future__ import annotations

import pytest

from _mesh_rows import (
    assert_leaves_close,
    assert_logits_close,
    config,
    job,
    port_mesh_run,
    reference_runs,
    tokens,
)
from _train_rows import one_thread  # noqa: F401

PHI, MIXTRAL = "phi3.5-moe-42b-a6.6b", "mixtral-8x22b"
JOBS = [
    job("phi-ep-2x2-fsdp-pipeline-drops", PHI, 2, 2, fsdp=True, pipeline=True, serve=True,
        capacity_factor=0.5),
    job("phi-ep-2x2-fsdp-fused-drops", PHI, 2, 2, fsdp=True, capacity_factor=0.5),
    job("phi-ep-1x4-fused", PHI, 1, 4),
    job("mixtral-tp-2x2-fsdp", MIXTRAL, 2, 2, fsdp=True, serve=True, capacity_factor=0.5),
    job("mixtral-tp-1x4", MIXTRAL, 1, 4),
]


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return reference_runs(JOBS, tmp_path_factory.mktemp("mesh_moe"))


@pytest.mark.parametrize("j", JOBS, ids=lambda j: j["id"])
def test_expert_rows_equal_the_reference_mesh(reference, j):
    ref = reference[j["id"]]
    cfg = config(j["row"], j["heads"], j["capacity_factor"])
    loss, grads, logits = port_mesh_run(cfg, ref["params"], tokens(cfg.vocab_size), j["data"],
                                        j["model"], fsdp=j["fsdp"], pipeline=j["pipeline"],
                                        serve=bool(j["serve"]))
    assert abs(loss - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    assert_leaves_close(grads, ref["grads"])
    if j["serve"]:
        assert_logits_close(logits[:1], ref["logits"][:1])
        assert_logits_close(logits[1:], ref["logits"][1:], tol=2e-4)
