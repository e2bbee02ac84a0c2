"""The port's exact narrow wire (``repro_torch.comm.compress``) against the
reference's ``repro.comm.compress``, run in-process on the CPU.

* ``narrow_cast``: the cast slab ``==`` the reference's, and its
  per-coloring flags ``==`` the reference's flag on each coloring's slab
  (its ``jax.vmap`` over colorings);
* ``mask_columns``: the packed words ``==`` the reference's bit for bit
  (the little-endian bit order is part of the wire format);
  ``mask_from_columns`` inverts them, as the reference's does;
  ``mask_column_count`` and ``wire_itemsize`` ``==`` the reference's;
* hypothesis sweeps lengths, capacities and slab values.

Every comparison is exact (``==``): the wire carries integers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from repro.comm import compress as ref
from repro_torch.comm import compress

WIRES = ("int16", "int8")
SWEEP = settings(max_examples=25, deadline=None,
                 suppress_health_check=[HealthCheck.too_slow])


def _ref_flags(x: np.ndarray, wire: str):
    """The reference's saturation flag of each coloring's slab (axis -2)."""
    out = []
    for b in range(x.shape[-2]):
        flags = []
        ref.narrow_cast(jnp.asarray(x[..., b, :]), wire, flags)
        out.append(bool(flags[0]))
    return out


@SWEEP
@given(rows=st.integers(1, 40), b=st.integers(1, 4), w=st.integers(1, 9),
       hi=st.sampled_from([2, 100, 128, 200, 32767, 32768, 70000]), wire=st.sampled_from(WIRES),
       seed=st.integers(0, 2**16))
def test_narrow_cast_equals_reference(rows, b, w, hi, wire, seed):
    x = np.random.default_rng(seed).integers(0, hi, (rows, b, w)).astype(np.float32)
    flags = []
    got = compress.narrow_cast(torch.from_numpy(x), wire, flags)
    want = np.asarray(ref.narrow_cast(jnp.asarray(x), wire))
    assert got.dtype == getattr(torch, wire) and np.array_equal(got.numpy(), want)
    assert len(flags) == 1 and flags[0].tolist() == _ref_flags(x, wire)
    if all(flags[0].tolist()):
        assert torch.equal(compress.widen(got), torch.from_numpy(x))


def test_narrow_cast_batched_chunks_and_identity():
    """A chunk stack ``[P, r, B, W]`` flags per coloring over every peer;
    float32 is the identity and appends no flag."""
    x = np.zeros((3, 5, 2, 4), np.float32)
    x[2, 1, 1, 3] = 200.0  # coloring 1 saturates int8 on one peer
    flags = []
    compress.narrow_cast(torch.from_numpy(x), "int8", flags)
    assert flags[0].tolist() == [True, False] == _ref_flags(x, "int8")
    t = torch.ones(2, 3)
    flags = []
    assert compress.narrow_cast(t, "float32", flags) is t and flags == []
    assert compress.widen(t) is t


@pytest.mark.parametrize("wire", ("float32",) + WIRES)
def test_wire_tables_equal_reference(wire):
    assert compress.wire_itemsize(wire) == ref.wire_itemsize(wire)
    assert compress.WIRE_DTYPES[wire][1:] == ref.WIRE_DTYPES[wire][1:]
    assert compress.WIRE_ESCALATION == ref.WIRE_ESCALATION


@SWEEP
@given(lead=st.integers(1, 3), r=st.integers(1, 300), cap=st.integers(1, 40),
       wire=st.sampled_from(WIRES), density=st.floats(0.0, 1.0), seed=st.integers(0, 2**16))
def test_mask_columns_equal_reference(lead, r, cap, wire, density, seed):
    mask = np.random.default_rng(seed).random((lead, r)) < density
    got = compress.mask_columns(torch.from_numpy(mask), cap, wire)
    want = np.asarray(ref.mask_columns(jnp.asarray(mask), cap, wire))
    assert got.dtype == getattr(torch, wire) and np.array_equal(got.numpy(), want)
    assert got.shape[-1] == compress.mask_column_count(r, cap, wire) == \
        ref.mask_column_count(r, cap, wire)
    back = compress.mask_from_columns(got, r, wire)
    assert np.array_equal(back.numpy(), mask)
    assert np.array_equal(back.numpy(), np.asarray(ref.mask_from_columns(jnp.asarray(want), r,
                                                                         wire)))


@pytest.mark.parametrize("wire", WIRES)
def test_mask_word_bit_order(wire):
    """Bit i of a word is entry i of its group (little-endian); a full word
    is -1 in the signed wire type, the top bit alone its minimum."""
    bits = 8 if wire == "int8" else 16
    mask = torch.zeros(3 * bits, dtype=torch.bool)
    mask[0] = True  # word 0 == 1
    mask[bits: 2 * bits] = True  # word 1 == -1
    mask[3 * bits - 1] = True  # word 2 == the minimum
    words = compress.mask_columns(mask, 3, wire)[:, 0].tolist()
    assert words == [1, -1, -(1 << (bits - 1))]
