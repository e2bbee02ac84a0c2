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

bf16 on 2 x 2 with FSDP (smollm-360m, the row ``chip_smoke.py`` trains on
a mesh): the reference's meshed bf16 run at its defaults, which cast the
weights of two or more dimensions where the forward uses them on a mesh,
is the oracle for the port's meshed bf16 loss and gradients, cast
(``build_model(cast_params=True)``) and uncast.  Each is held to the repo's
bf16 rule (tests/test_torch_train_bf16.py): a gradient leaf's distance
from the reference's float32 run within twice the reference's own bf16
distance plus 1e-3 of the leaf's norm, and the loss's likewise.  The
port's default is the setting that comes closer to the oracle.
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
from _train_rows import LEAF_FLOOR, LEAF_RATIO, leaf_distances, one_thread  # noqa: F401
from repro_torch.models import build_model

MESHES = [(2, 2), (1, 4), (4, 1)]
CUT = (6, 3)

JOBS = [job(f"{row}-2x2", row, 2, 2, fsdp=row in ("smollm-360m", "internlm2-1.8b"),
            serve=row == "smollm-360m") for row in DENSE]
JOBS.append(job("cut-1x4", "smollm-360m", 1, 4, serve=True, heads=CUT))
F32_JOBS = list(JOBS)
#: the oracle of the bf16 cases, beside its float32 run smollm-360m-2x2
JOBS.append(job("smollm-360m-2x2-bf16", "smollm-360m", 2, 2, fsdp=True, dtype="bfloat16"))


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


@pytest.mark.parametrize("j", F32_JOBS, ids=lambda j: j["id"])
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


_BF16 = {}


def _bf16_run(reference, cast):
    """The port's meshed bf16 loss and gradients on smollm-360m 2 x 2 with
    FSDP, on the reference's weights (``cast``: ``build_model``'s
    ``cast_params``, its default where None), once per setting."""
    if cast not in _BF16:
        cfg = config("smollm-360m")
        loss, grads, _ = port_mesh_run(cfg, reference["smollm-360m-2x2"]["params"],
                                       tokens(cfg.vocab_size), 2, 2, fsdp=True,
                                       dtype=torch.bfloat16, cast_params=cast)
        _BF16[cast] = loss, grads
    return _BF16[cast]


def _distance(grads, want) -> float:
    """The whole gradient's distance from ``want``'s, over its norm."""
    num = sum(float((grads[k] - torch.as_tensor(w)).square().sum()) for k, w in want.items())
    den = sum(float(torch.as_tensor(w).square().sum()) for w in want.values())
    return (num / den) ** 0.5


@pytest.mark.parametrize("cast", [True, False], ids=["cast", "uncast"])
def test_meshed_bf16_holds_the_reference_rule(reference, cast):
    ref32, want = reference["smollm-360m-2x2"], reference["smollm-360m-2x2-bf16"]
    loss, grads = _bf16_run(reference, cast)
    base = ref32["loss"]
    assert abs(loss - base) <= LEAF_RATIO * abs(want["loss"] - base) + LEAF_FLOOR * abs(base)
    assert all(torch.isfinite(g).all() for g in grads.values())
    g32 = {k: torch.as_tensor(w) for k, w in ref32["grads"].items()}
    for k, (got, ref) in leaf_distances(g32, grads, want["grads"]).items():
        assert got <= LEAF_RATIO * ref + LEAF_FLOOR, (k, got, ref)


def test_default_cast_is_the_closer_to_the_reference(reference):
    """``build_model``'s default on a mesh is whichever of cast and uncast
    puts the whole gradient, then the loss, nearer the reference's meshed
    bf16 run (a tie goes to the reference's own default, cast)."""
    want = reference["smollm-360m-2x2-bf16"]
    runs = {cast: _bf16_run(reference, cast) for cast in (True, False)}
    far = {cast: (_distance(grads, want["grads"]), abs(loss - want["loss"]))
           for cast, (loss, grads) in runs.items()}
    closer = far[True] <= far[False]
    loss, grads = _bf16_run(reference, None)
    assert loss == runs[closer][0], far
    assert all(torch.equal(grads[k], runs[closer][1][k]) for k in grads), far
