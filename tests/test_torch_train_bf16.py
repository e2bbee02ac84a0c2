"""The rows' loss and gradients in bf16 compute against the JAX package,
and the remat modes against each other (``tests/_train_rows.py``'s rows,
weights and batches; float32 is ``tests/test_torch_train.py``'s).

Tolerances: the bf16 loss within 2e-2 relative of the reference's bf16
loss.  A bf16 gradient leaf is not held to its own norm, as rounding in
other places moves a cancelling sum far (rwkv6-3b's ``u_bonus``: 14.5% from
the float32 gradient in the port).  Each leaf's distance from the float32
gradient (the port's, itself within 1e-4 of the reference's) is held
instead to at most twice the reference's own bf16 distance for that leaf,
plus 1e-3 of the leaf's norm.  The reference for that check is compiled
with ``xla_allow_excess_precision`` off, so that it rounds each bf16
operation as eager torch does: by default XLA keeps fused bf16 chains in
float32, which puts ``u_bonus`` 7.4% from float32 (11.0% when it rounds).
The port measured at most 1.32x the rounding reference's distance on any
leaf of any row (``PYTHONPATH=src python tests/_train_rows.py`` prints each
row's farthest leaves).  The whole bf16 gradient is also held to at most
1.5x the default reference's distance from float32, the ratio the served
bf16 rows are held to.
"""

import pytest
import torch

from _train_rows import (  # noqa: F401
    LEAF_FLOOR,
    LEAF_RATIO,
    ROWS,
    leaf_distances,
    one_thread,
    port,
    reference,
)

BF16_RATIO = 1.5


@pytest.mark.parametrize("name", ROWS)
def test_loss_and_gradients_match_reference_bf16(name):
    want_loss, want = reference(name, "bfloat16")
    _, rounded = reference(name, "bfloat16", excess_precision=False)
    loss, grads = port(name, "bfloat16")
    _, grads32 = port(name, "float32")
    assert abs(loss - want_loss) <= 2e-2 * abs(want_loss)
    assert all(torch.isfinite(g).all() for g in grads.values())
    for k, (got, ref) in leaf_distances(grads32, grads, rounded).items():
        assert got <= LEAF_RATIO * ref + LEAF_FLOOR, (k, got, ref)
    flat = lambda d: torch.cat([torch.as_tensor(d[k]).float().reshape(-1)  # noqa: E731
                                for k in sorted(want)])
    g, w, w32 = flat(grads), flat(want), flat(grads32)
    assert (g - w32).norm() <= BF16_RATIO * (w - w32).norm()


@pytest.mark.parametrize("name", ROWS)
def test_remat_modes_give_the_same_gradients(name):
    """``full``, ``dots`` and ``none`` recompute the same values: the same
    loss and gradients, bitwise on the CPU; at a 16-token attention tile the
    KV-step checkpoints nest inside the layers' (S = 64: 4 x 4 tiles)."""
    base_loss, base = port(name, "float32", remat="none", attn_chunk=16)
    for remat in ("full", "dots"):
        loss, grads = port(name, "float32", remat=remat, attn_chunk=16)
        assert loss == base_loss
        assert all(torch.equal(grads[k], base[k]) for k in base), remat
