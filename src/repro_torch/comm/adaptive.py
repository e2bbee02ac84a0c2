"""Adaptive mode selection: the paper's §3.2.2 cost model.

Counterpart of ``repro/comm/adaptive.py``; the cost functions are the
reference's, term for term, so the port routes a node as the reference
does on equal inputs.  The pipelined exchange wins when each chunk's
compute hides its transfer (overlap ratio rho_w -> 1, Eq. 14) and the
per-step latency ``alpha W`` is amortized; the one-shot all-to-all wins for
small payloads.  Costs follow the Hockney model (Eq. 8):

    T_fused    = alpha + beta B_total + T_comp_total
    T_pipeline = W alpha + beta B_chunk                 (cold start, Eq. 15)
                 + sum_w max(T_comp_chunk, beta B_chunk)

:func:`calibrate` measures alpha and beta on a mesh instead of assuming
them: it times ``shift`` at three payload sizes.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Tuple

__all__ = [
    "HockneyModel",
    "V5E_ICI",
    "V5E_DCI",
    "overlap_ratio",
    "pipeline_cost",
    "fused_cost",
    "choose_mode",
    "choose_mode_full",
    "calibrate",
]


@dataclasses.dataclass(frozen=True)
class HockneyModel:
    """alpha/beta link model and compute rate for one mesh axis."""

    alpha: float  # per-operation latency, seconds
    beta: float  # seconds per byte (1 / link bandwidth)
    flops_per_s: float  # effective compute rate of one device


# The reference's assumed link constants for a TPU v5e (``repro/comm/
# adaptive.py:52-53``), kept under its names so that the port's routes can
# be held equal to the reference's: 197 TFLOP/s, about 50 GB/s per ICI link
# and 5 us a hop; the inter-pod DCI twice as slow.  They describe no link of
# the port's hardware: ``calibrate`` measures a mesh's own.
V5E_ICI = HockneyModel(alpha=5e-6, beta=1.0 / 50e9, flops_per_s=197e12)
V5E_DCI = HockneyModel(alpha=20e-6, beta=1.0 / 25e9, flops_per_s=197e12)


def overlap_ratio(comp_chunk_s: float, comm_chunk_s: float) -> float:
    """rho_w of Eq. 14: the share of a chunk's transfer hidden by compute."""
    if comm_chunk_s <= 0:
        return 1.0
    return min(comp_chunk_s, comm_chunk_s) / comm_chunk_s


def pipeline_cost(total_bytes: float, total_flops: float, P: int, model: HockneyModel,
                  group_factor: int = 1) -> float:
    """Modeled wall time of the grouped pipelined exchange (Eq. 13/15)."""
    W = max(1, math.ceil((P - 1) / max(1, group_factor)))
    b_chunk = total_bytes / max(1, P - 1) * group_factor
    comp_chunk = total_flops / max(1, P) / model.flops_per_s
    comm_chunk = model.alpha + model.beta * b_chunk
    # the cold start pays one whole transfer; later steps overlap
    return comm_chunk + sum(max(comp_chunk, comm_chunk) for _ in range(W - 1)) + comp_chunk


def fused_cost(total_bytes: float, total_flops: float, model: HockneyModel) -> float:
    """Modeled wall time of one all-to-all and the whole compute (no overlap)."""
    return model.alpha + model.beta * total_bytes + total_flops / model.flops_per_s


def choose_mode(total_bytes: float, total_flops: float, P: int,
                model: HockneyModel = V5E_ICI, group_factor: int = 1) -> Tuple[str, dict]:
    """``'pipeline'`` or ``'alltoall'`` for one exchange, with diagnostics.

    ``total_bytes`` is what this rank exchanges across the axis,
    ``total_flops`` the compute consuming it on this rank."""
    tp = pipeline_cost(total_bytes, total_flops, P, model, group_factor)
    tf = fused_cost(total_bytes, total_flops, model)
    comp_chunk = total_flops / max(1, P) / model.flops_per_s
    comm_chunk = model.alpha + model.beta * total_bytes / max(1, P - 1)
    diag = {
        "pipeline_cost_s": tp,
        "fused_cost_s": tf,
        "rho": overlap_ratio(comp_chunk, comm_chunk),
        "intensity_flops_per_byte": total_flops / max(total_bytes, 1.0),
    }
    return ("pipeline" if tp <= tf else "alltoall"), diag


def choose_mode_full(a2a_bytes: float, ring_bytes: float, total_flops: float, P: int,
                     model: HockneyModel = V5E_ICI, group_factor: int = 1) -> Tuple[str, dict]:
    """The cheapest of the three schedules for one node.

    ``a2a_bytes`` is what alltoall and pipeline ship (per-peer request
    chunks), ``ring_bytes`` the ring's whole-shard relays, costed as a
    fully pipelined (group 1) schedule."""
    costs: Dict[str, float] = {
        "alltoall": fused_cost(a2a_bytes, total_flops, model),
        "pipeline": pipeline_cost(a2a_bytes, total_flops, P, model, group_factor),
        "ring": pipeline_cost(ring_bytes, total_flops, P, model, 1),
    }
    mode = min(costs, key=costs.get)
    comp_chunk = total_flops / max(1, P) / model.flops_per_s
    comm_chunk = model.alpha + model.beta * a2a_bytes / max(1, P - 1)
    diag = {
        "costs_s": costs,
        "predicted_s": costs[mode],
        "rho": overlap_ratio(comp_chunk, comm_chunk),
        "intensity_flops_per_byte": total_flops / max(a2a_bytes, 1.0),
    }
    return mode, diag


#: calibrations, keyed by (device type, device name, data ranks, payloads):
#: a property of the link, not of the plan
_CALIBRATION_CACHE: Dict[tuple, HockneyModel] = {}


def _fit(payload_bytes, times, base: HockneyModel) -> Tuple[float, float]:
    """Least squares ``t = alpha + beta S`` over the probe sizes, clamped
    as the reference clamps them."""
    m = len(payload_bytes)
    sx = sum(float(s) for s in payload_bytes)
    sy = sum(times)
    sxx = sum(float(s) ** 2 for s in payload_bytes)
    sxy = sum(float(s) * t for s, t in zip(payload_bytes, times))
    denom = m * sxx - sx * sx
    beta = (m * sxy - sx * sy) / denom if denom else base.beta
    alpha = (sy - beta * sx) / m
    return min(max(alpha, 1e-8), 1.0), min(max(beta, 1e-13), 1e-3)


def calibrate(mesh, *, payload_bytes: Tuple[int, ...] = (1 << 16, 1 << 19, 1 << 22),
              repeats: int = 3, base: HockneyModel = V5E_ICI) -> HockneyModel:
    """alpha and beta measured on ``mesh``'s data axis, and a matmul rate.

    Every rank times one ``shift`` by 1 at each payload size (best of
    ``repeats`` after a warm-up; the ranks meet at a barrier around each
    shift and the device is synchronized), the ranks average their times
    with ``all_reduce_sum`` (so every rank fits the same model and routes
    alike), and ``t = alpha + beta S`` is fitted by least squares; a
    ``[512, 512]`` float32 matmul gives ``flops_per_s``.  On a
    ``LocalMesh`` the shift is a copy on the device, so alpha and beta
    describe the thread exchange, not a link.  Cached per device kind,
    rank count and payloads; a mesh with one data rank, or an abstract
    one (``meta``, the dry-run's), returns ``base``: there is no link to
    measure.
    """
    import torch

    P = mesh.data_size
    if P <= 1 or mesh.device.type == "meta":
        return base
    dev = mesh.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    cache_key = (dev.type, name, P, tuple(payload_bytes))
    hit = _CALIBRATION_CACHE.get(cache_key)
    if hit is not None:
        return hit

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def best(ctx, fn) -> float:
        fn()  # warm
        t = math.inf
        for _ in range(max(1, repeats)):
            ctx.data.barrier()
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            t = min(t, time.perf_counter() - t0)
        return t

    def probe(ctx):
        times = []
        for nbytes in payload_bytes:
            x = torch.ones(max(1, nbytes // 4), dtype=torch.float32, device=dev)
            times.append(best(ctx, lambda: ctx.data.shift(x, 1)))
        a = torch.ones((512, 512), dtype=torch.float32, device=dev)
        times.append(best(ctx, lambda: a @ a))
        mean = ctx.data.all_reduce_sum(torch.tensor(times, dtype=torch.float64, device=dev)) / P
        return mean.cpu().tolist()

    times = mesh.run(probe)[0]
    alpha, beta = _fit(payload_bytes, times[:-1], base)
    flops = min(max(2.0 * 512 ** 3 / max(times[-1], 1e-9), 1e9), 1e16)
    fitted = HockneyModel(alpha=alpha, beta=beta, flops_per_s=flops)
    _CALIBRATION_CACHE[cache_key] = fitted
    return fitted
