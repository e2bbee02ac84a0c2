"""Roofline analysis of dry-run records, against one NVIDIA H100.

Counterpart of ``repro/roofline/analysis.py``.  Per record (one rank of a
cell, :mod:`repro_torch.launch.dryrun`), three terms:

  compute    = float32 adds and FMAs / 33.5e12 a second (a counting
               record: count tables stay exact, off the tensor cores), or
               flops / 989e12 (bf16 tensor cores, an LM record)
  memory     = bytes accessed / 3.35e12 bytes a second (HBM3)
  collective = the rank's collective bytes / the link's rate

The records are per rank, so no division by the chip count.  The largest
term is the least time a call could take; ``fits`` holds the rank's
arguments, output and temporaries against the card's memory: 80 GB (the
data sheet), or ``torch.cuda.get_device_properties(0).total_memory`` where
a card is present.  :func:`bound_s` is the same roofline for one kernel's
:class:`~repro_torch.kernels.work.Work`, the bound column of
``chip_smoke.py`` and ``PERF.md``.

The rates are the H100 SXM data sheet's.  The links are not measured here:
NVLink 4 within a host of 8 cards, one 400 Gb/s NDR adapter a card between
hosts; a data axis of more than 8 ranks crosses hosts.  Pass ``beta`` (the
seconds a byte of ``comm.calibrate``'s fit on a real mesh) to use a
measured link instead.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import List, Optional, Tuple

__all__ = [
    "HBM_BYTES_PER_S",
    "FP32_OPS_PER_S",
    "BF16_FLOPS_PER_S",
    "HBM_BYTES",
    "NVLINK_BYTES_PER_S",
    "INTER_NODE_BYTES_PER_S",
    "CARDS_A_HOST",
    "RooflineTerms",
    "bound_s",
    "device_memory_bytes",
    "link_bytes_per_s",
    "analyze_record",
    "analyze_dir",
    "format_table",
]

#: HBM3 bytes a second (data sheet)
HBM_BYTES_PER_S = 3.35e12
#: float32 outside the tensor cores: 67e12 flop/s with an FMA as two, so
#: 33.5e12 adds or FMAs a second, a lone add at the FMA's rate (data sheet)
FP32_OPS_PER_S = 33.5e12
#: bf16 tensor cores, dense (data sheet)
BF16_FLOPS_PER_S = 989e12
#: device memory (data sheet), where no card is present to ask
HBM_BYTES = 80e9
#: NVLink 4: 900 GB/s a card to the others of its host, 450e9 each way
#: (data sheet; not measured)
NVLINK_BYTES_PER_S = 450e9
#: between hosts: one ConnectX-7 NDR adapter a card, 400 Gb/s each way
#: (data sheet; not measured)
INTER_NODE_BYTES_PER_S = 400e9 / 8
#: cards one host joins by NVLink
CARDS_A_HOST = 8


@dataclasses.dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: float
    flops: float  # per rank
    useful_ratio: float  # model flops / (flops x chips)
    temp_gib: float
    rank_gib: float  # arguments + output + temporaries
    fits: bool
    mode: str = ""

    @property
    def step_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """The compute term over the dominant one: 1.0 when compute-bound."""
        return self.compute_s / self.step_s if self.step_s > 0 else 0.0


def bound_s(w) -> Tuple[float, str]:
    """The least time the H100 could take for one launch's
    :class:`~repro_torch.kernels.work.Work`: the larger of its bytes at the
    HBM rate and its operations (float32 adds and FMAs, bf16 tensor-core
    flops) at their peaks; and which of the two it is."""
    t_bytes = w.bytes / HBM_BYTES_PER_S
    t_ops = (w.adds + w.fmas) / FP32_OPS_PER_S + w.bf16_flops / BF16_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_memory_bytes() -> float:
    """The card's memory where one is present, else the data sheet's 80 GB."""
    import torch

    if torch.cuda.is_available():
        return float(torch.cuda.get_device_properties(0).total_memory)
    return HBM_BYTES


def link_bytes_per_s(rec: dict, beta: Optional[float] = None) -> float:
    """The link a record's collectives cross: ``1 / beta`` where given, else
    NVLink for a data axis within one host, the inter-host link past it."""
    if beta:
        return 1.0 / beta
    ranks = rec.get("data_ranks", rec.get("chips", 1))
    return NVLINK_BYTES_PER_S if ranks <= CARDS_A_HOST else INTER_NODE_BYTES_PER_S


def _model_flops(rec: dict) -> float:
    """6 N D a training step, 2 N D forward only (prefill, decode); a
    counting record has no token model."""
    n = rec.get("active_params", rec.get("params", 0))
    if "global_batch" not in rec:
        return 0.0
    kind = rec.get("kind", "train")
    tokens = rec["global_batch"] * (rec["seq_len"] if kind in ("train", "prefill") else 1)
    return (6.0 if kind == "train" else 2.0) * n * tokens


def analyze_record(rec: dict, hbm_bytes: Optional[float] = None,
                   beta: Optional[float] = None) -> Optional[RooflineTerms]:
    """The roofline terms of one ``ok`` record (None otherwise).
    ``hbm_bytes`` defaults to :func:`device_memory_bytes`, ``beta`` to the
    data sheet's links (:func:`link_bytes_per_s`)."""
    if rec.get("status") != "ok":
        return None
    cost = rec["cost"]
    if rec["arch"].startswith("counting:"):
        compute_s = (cost.get("fp32_ops", cost["flops"]) / FP32_OPS_PER_S
                     + cost.get("bf16_flops", 0.0) / BF16_FLOPS_PER_S)
    else:
        compute_s = cost["flops"] / BF16_FLOPS_PER_S
    memory_s = cost["bytes_accessed"] / HBM_BYTES_PER_S
    coll = rec.get("collectives", {})
    coll_bytes = sum(v for k, v in coll.items() if k != "ops" and isinstance(v, (int, float)))
    collective_s = coll_bytes / link_bytes_per_s(rec, beta)
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    dominant = max(terms, key=terms.get)
    mem = rec.get("memory", {})
    temp = mem.get("temp_bytes", 0)
    rank = mem.get("argument_bytes", 0) + mem.get("output_bytes", 0) + temp
    hbm = device_memory_bytes() if hbm_bytes is None else hbm_bytes
    chips = rec["chips"]
    mf = _model_flops(rec)
    return RooflineTerms(
        arch=rec["arch"], shape=rec.get("shape", ""), mesh=rec["mesh"], chips=chips,
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s, dominant=dominant,
        model_flops=mf, flops=cost["flops"],
        useful_ratio=mf / (cost["flops"] * chips) if cost["flops"] else 0.0,
        temp_gib=temp / 2**30, rank_gib=rank / 2**30, fits=rank <= hbm,
        mode=rec.get("mode", ""))


def analyze_dir(path: str, hbm_bytes: Optional[float] = None,
                beta: Optional[float] = None) -> List[RooflineTerms]:
    """:func:`analyze_record` of every ``*.json`` record in ``path``."""
    out = []
    for f in sorted(glob.glob(os.path.join(path, "*.json"))):
        with open(f) as fh:
            t = analyze_record(json.load(fh), hbm_bytes, beta)
        if t:
            out.append(t)
    return out


def format_table(terms: List[RooflineTerms]) -> str:
    hdr = (f"{'arch':<28}{'shape':<24}{'mesh':<12}{'mode':<10}{'comp_s':>11}{'mem_s':>11}"
           f"{'coll_s':>11}{'domin':>7}{'roofl%':>8}{'tempGiB':>9}{'rankGiB':>9}{'fits':>6}")
    lines = [hdr, "-" * len(hdr)]
    for t in terms:
        lines.append(
            f"{t.arch:<28}{t.shape[:23]:<24}{t.mesh:<12}{t.mode:<10}{t.compute_s:>11.4g}"
            f"{t.memory_s:>11.4g}{t.collective_s:>11.4g}{t.dominant[:5]:>7}"
            f"{100 * t.roofline_fraction:>7.1f}%{t.temp_gib:>9.2f}{t.rank_gib:>9.2f}"
            f"{str(t.fits):>6}")
    return "\n".join(lines)


def main(argv=None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="roofline terms of dry-run records (H100)")
    ap.add_argument("dir", nargs="?", default="results/dryrun")
    ap.add_argument("--beta", type=float, default=None,
                    help="seconds a byte of a measured link (comm.calibrate's beta)")
    args = ap.parse_args(argv)
    print(format_table(analyze_dir(args.dir, beta=args.beta)))


if __name__ == "__main__":
    main()
