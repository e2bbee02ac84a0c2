"""Plain PyTorch versions of the four count-table kernels and of flash attention.

They are the kernels' oracles: the CPU runs them (every wrapper routes a
CPU tensor here), and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card.  Tables are ``[rows, B, W]`` (vertex-major, one
``W``-wide block per coloring); every function works on the trailing
column axis and treats the leading axes as rows.

Large intermediates are chunked to about 2^27 elements, as the reference's
XLA combine is (``repro/kernels/ops.py:529-556``): at the widths of the
u12-2 template on a 2^20-vertex graph, an unchunked ``[rows, S, J]`` gather
or ``[E, B*W]`` edge gather would not fit on the card.
"""

from __future__ import annotations

import torch

__all__ = [
    "ELEMENT_BUDGET",
    "spmm_ref",
    "spmm_segment_ref",
    "spmm_csr_order_ref",
    "unpack_patches",
    "spmm_block_ref",
    "color_combine_ref",
    "fused_count_ref",
    "flash_attention_ref",
]

#: bound on the elements of one chunked gather intermediate
ELEMENT_BUDGET = 1 << 27


def spmm_ref(rows: torch.Tensor, cols: torch.Tensor, table: torch.Tensor,
             num_rows: int) -> torch.Tensor:
    """Neighbor sum ``out[v] = sum_{(v, u)} table[u]`` over a COO edge list,
    by one scatter-add: the reference's oracle (``repro/kernels/ref.py:22``).

    ``rows`` and ``cols`` are the expanded directed edge list; padded
    entries point at a zero sentinel row of ``table`` and at output row
    ``num_rows``.  The output has ``num_rows + 1`` rows, the last the
    discarded sentinel row.  A plain oracle: the engine's SpMMs walk CSRs.
    """
    out = torch.zeros((num_rows + 1,) + tuple(table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    return out.index_add_(0, rows.long(), table[cols.long()])


def spmm_segment_ref(indptr: torch.Tensor, indices: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Neighbor sum ``out[v] = sum_{indptr[v] <= e < indptr[v+1]} table[indices[e]]``.

    ``indptr`` has ``rows + 1`` entries (offsets into ``indices``; the first
    need not be 0, so a slice of a larger CSR works); ``table`` is
    ``[C, ...]``.  Returns ``[rows, ...]`` via ``index_add_`` over chunks of
    edges.
    """
    rows = indptr.numel() - 1
    flat = table.reshape(table.shape[0], -1)
    width = flat.shape[1]
    out = torch.zeros((rows, width), dtype=table.dtype, device=table.device)
    base = int(indptr[0])
    deg = torch.diff(indptr)
    dst = torch.repeat_interleave(torch.arange(rows, device=table.device), deg)
    n_edges = dst.numel()
    chunk = max(1, ELEMENT_BUDGET // max(width, 1))
    for e0 in range(0, n_edges, chunk):
        e1 = min(e0 + chunk, n_edges)
        src = indices[base + e0 : base + e1].long()
        out.index_add_(0, dst[e0:e1], flat[src])
    return out.reshape((rows,) + tuple(table.shape[1:]))


def spmm_csr_order_ref(indptr: torch.Tensor, indices: torch.Tensor,
                       table: torch.Tensor) -> torch.Tensor:
    """The neighbor sum of :func:`spmm_segment_ref`, added in the order the
    CUDA kernels fix: one float32 accumulator per output element, starting
    at 0, adding ``table[u]`` for the row's neighbors ``u`` in CSR order.

    Step ``k`` adds the ``k``-th neighbor of every row whose degree exceeds
    ``k`` (rows sorted by degree, so the rows still walking are a prefix),
    with plain elementwise adds and no atomics: sums past 2^24 round as the
    kernels round them.  ``max_degree`` steps of one gather each, so it is
    meant for narrow tables.
    """
    rows = indptr.numel() - 1
    flat = table.reshape(table.shape[0], -1)
    deg = torch.diff(indptr)
    order = torch.argsort(deg, descending=True, stable=True)
    start = indptr[:-1][order]
    walking = torch.bincount(deg, minlength=1).flip(0).cumsum(0).flip(0)  # [k]: rows with deg >= k
    acc = torch.zeros((rows, flat.shape[1]), dtype=table.dtype, device=table.device)
    for k, n in enumerate(walking[1:].tolist()):
        acc[:n] += flat[indices[start[:n] + k].long()]
    out = torch.empty_like(acc)
    out[order] = acc
    return out.reshape((rows,) + tuple(table.shape[1:]))


def unpack_patches(bits: torch.Tensor) -> torch.Tensor:
    """``[P, R, R/32]`` int32 bitmask words -> ``[P, R, R]`` 0/1 float32 patches
    (bit ``k % 32`` of word ``k // 32`` is column ``k``)."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    dense = (bits[..., None] >> shifts) & 1
    return dense.reshape(bits.shape[0], bits.shape[1], -1).to(torch.float32)


def spmm_block_ref(
    patch_ptr: torch.Tensor, patch_col: torch.Tensor, patch_bits: torch.Tensor, table: torch.Tensor
) -> torch.Tensor:
    """Block-dense neighbor sum over 0/1 patches (the reference's XLA
    oracle, ``repro/kernels/ops.py:366-373``).

    For patch ``p`` of row block ``R`` (``patch_ptr[R] <= p <
    patch_ptr[R+1]``) and column block ``patch_col[p]``: unpack its bitmask
    to a dense ``[128, 128]`` float32 patch, gather the source block
    ``table[128 * col : 128 * col + 128]``, multiply, and add the product
    into output row block ``R``.  Row blocks without a patch are zero.
    ``table`` is ``[n_pad, ...]`` with ``n_pad = 128 * (patch_ptr.numel() -
    1)``; chunked over patches within :data:`ELEMENT_BUDGET`.
    """
    vb = patch_bits.shape[1]
    nrb = patch_ptr.numel() - 1
    flat = table.reshape(nrb, vb, -1)
    width = flat.shape[2]
    out = torch.zeros_like(flat)
    patch_row = torch.repeat_interleave(torch.arange(nrb, device=table.device),
                                        torch.diff(patch_ptr.long()))
    n_patches = patch_col.numel()
    chunk = max(1, ELEMENT_BUDGET // (vb * max(width, vb)))
    for p0 in range(0, n_patches, chunk):
        p1 = min(p0 + chunk, n_patches)
        src = flat[patch_col[p0:p1].long()]
        out.index_add_(0, patch_row[p0:p1], torch.bmm(unpack_patches(patch_bits[p0:p1]), src))
    return out.reshape(table.shape)


def color_combine_ref(
    left: torch.Tensor, m: torch.Tensor, idx1: torch.Tensor, idx2: torch.Tensor
) -> torch.Tensor:
    """``out[r, s] = sum_j left[r, idx1[s, j]] * m[r, idx2[s, j]]``.

    ``left`` is ``[..., A]`` and ``m`` ``[..., Bw]`` with equal leading
    axes; ``idx1``/``idx2`` are the ``[S, J]`` split tables.  Returns
    ``[..., S]``, chunked over rows so the ``[rows, S, J]`` gather stays
    within :data:`ELEMENT_BUDGET`.
    """
    lead = left.shape[:-1]
    l2 = left.reshape(-1, left.shape[-1])
    m2 = m.reshape(-1, m.shape[-1])
    s, j = idx1.shape
    rows = l2.shape[0]
    out = torch.empty((rows, s), dtype=left.dtype, device=left.device)
    chunk = max(1, ELEMENT_BUDGET // max(s * j, 1))
    for r0 in range(0, rows, chunk):
        r1 = min(r0 + chunk, rows)
        out[r0:r1] = (l2[r0:r1][:, idx1] * m2[r0:r1][:, idx2]).sum(-1)
    return out.reshape(tuple(lead) + (s,))


def fused_count_ref(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    left: torch.Tensor,
    right: torch.Tensor,
    idx1: torch.Tensor,
    idx2: torch.Tensor,
    *,
    row_block: int = 4096,
) -> torch.Tensor:
    """``color_combine_ref(left, spmm_segment_ref(indptr, indices, right), ...)``
    computed ``row_block`` destination rows at a time.

    The neighbor sum exists only as one ``[row_block, ...]`` block at a time
    and never as a whole ``[rows, B, W]`` table: the plain counterpart of
    the fused kernel's shared-memory block.  ``left`` is ``[rows, ..., A]``
    with ``rows = indptr.numel() - 1``; ``right`` is ``[C, ..., W]`` with
    ``indices`` below ``C`` (a compact source need not have ``rows`` rows).
    """
    rows = indptr.numel() - 1
    out = torch.empty(tuple(left.shape[:-1]) + (idx1.shape[0],), dtype=left.dtype,
                      device=left.device)
    for r0 in range(0, rows, row_block):
        r1 = min(r0 + row_block, rows)
        m_blk = spmm_segment_ref(indptr[r0 : r1 + 1], indices, right)
        out[r0:r1] = color_combine_ref(left[r0:r1], m_blk, idx1, idx2)
    return out


#: the finite mask value of the TPU flash kernel (``flash_attention.py:31``)
NEG = -1e30


def flash_attention_ref(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: float | None = None,
) -> torch.Tensor:
    """Softmax attention as the TPU flash kernel computes it.

    ``q`` is ``[B, Hq, Lq, D]``, ``k`` and ``v`` ``[B, Hkv, Lk, D]``; query
    head ``h`` reads KV head ``h // (Hq / Hkv)`` (GQA).  In float32: logits
    ``q k^T * scale`` (``D**-0.5`` unless given), masked with the
    finite ``-1e30`` where ``kpos > qpos`` (``causal``) or ``kpos <= qpos -
    window`` (``window > 0``), query positions aligned to the end of the keys
    (``qpos = i + Lk - Lq``); then ``p = exp(logits - max)`` zeroed where
    masked, ``out = (p v) / l`` with ``l = sum p`` and ``l == 0`` read as 1, so
    a fully masked row gives 0.  The output is in ``q``'s dtype.  Chunked per
    (batch, KV head) and over query rows, so the logits of one chunk stay
    within :data:`ELEMENT_BUDGET` and no ``[B, H, Lq, Lk]`` tensor is made.
    """
    b, hq, lq, d = q.shape
    hkv, lk = k.shape[1], k.shape[2]
    if hq % hkv:
        raise ValueError(f"{hq} query heads do not group over {hkv} KV heads")
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    out = torch.empty_like(q)
    qpos = torch.arange(lq, device=q.device) + (lk - lq)
    kpos = torch.arange(lk, device=q.device)
    rows = max(1, ELEMENT_BUDGET // (g * max(lk, 1)))
    for ib in range(b):
        for kh in range(hkv):
            kf, vf = k[ib, kh].float(), v[ib, kh].float()
            heads = slice(kh * g, (kh + 1) * g)
            for r0 in range(0, lq, rows):
                r1 = min(r0 + rows, lq)
                logits = (q[ib, heads, r0:r1].float() @ kf.T) * scale  # [g, r, Lk]
                mask = torch.ones((r1 - r0, lk), dtype=torch.bool, device=q.device)
                if causal:
                    mask &= kpos[None, :] <= qpos[r0:r1, None]
                if window > 0:
                    mask &= kpos[None, :] > qpos[r0:r1, None] - window
                logits = torch.where(mask, logits, NEG)
                p = torch.exp(logits - logits.amax(-1, keepdim=True))
                p = torch.where(mask, p, 0.0)
                l = p.sum(-1, keepdim=True)
                l = torch.where(l == 0.0, 1.0, l)
                out[ib, heads, r0:r1] = ((p @ vf) / l).to(q.dtype)
    return out
