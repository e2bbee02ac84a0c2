"""Render the port's dry-run records into a Markdown file, between markers.

The records are what ``python -m repro_torch.launch.dryrun ... --out DIR``
writes (counting rows and LM cells alike, one JSON file each); the roofline
terms are ``repro_torch.roofline.analysis.analyze_record``'s, against one
NVIDIA H100.  The dry-run summary goes after ``<!-- DRYRUN_SUMMARY -->`` and
the roofline table after ``<!-- ROOFLINE_TABLE -->``, the markers
``tools/render_experiments.py`` writes after; each block ends at a closing
``<!-- /DRYRUN_SUMMARY -->`` (``<!-- /ROOFLINE_TABLE -->``) this tool adds,
so a second run replaces what the first wrote.  The port's records time
their analysis (``analysis_s``) where the reference's timed XLA's compile.

Run:  PYTHONPATH=src python tools/torch_render_experiments.py EXPERIMENTS.md \\
          [--records results/dryrun]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
from typing import List, Optional, Sequence

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src"))

from repro_torch.roofline.analysis import analyze_record  # noqa: E402

NOTES = {
    "memory": "HBM-bound: fewer bytes a step (fuse, reshard, narrower tables)",
    "collective": "link-bound: overlap or shrink the exchange (ring/pipelined modes, "
                  "narrow wire, gradient compression)",
    "compute": "compute-bound: at the roofline for this shape",
}


def load(directory: str) -> List[dict]:
    recs = []
    for f in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def _key(r: dict):
    return (r["arch"], r.get("shape", ""), r["mesh"], r.get("mode", ""))


def dryrun_summary(recs: List[dict]) -> str:
    lines = [
        "| arch | shape | mesh | mode | status | temp GiB/rank | analysis s |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=_key):
        head = f"| {r['arch']} | {r.get('shape', '')} | {r['mesh']} | {r.get('mode', '')} |"
        if r["status"] == "ok":
            t = r["memory"]["temp_bytes"] / 2**30
            lines.append(f"{head} ok | {t:.2f} | {r.get('analysis_s', 0.0):.2f} |")
        elif r["status"] == "skipped":
            lines.append(f"{head} skipped ({r['reason'].split(':')[0]}) | — | — |")
        else:
            lines.append(f"{head} **ERROR** | — | — |")
    ok = sum(r["status"] == "ok" for r in recs)
    sk = sum(r["status"] == "skipped" for r in recs)
    er = sum(r["status"] == "error" for r in recs)
    lines += ["", f"**{ok} ok / {sk} skipped (documented) / {er} errors.**"]
    return "\n".join(lines)


def roofline_table(recs: List[dict]) -> str:
    lines = [
        "| arch | shape | mesh | mode | compute s | memory s | collective s | dominant "
        "| useful | roofline frac | rank GiB | fits | one-line bottleneck note |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(recs, key=_key):
        t = analyze_record(r)
        if t is None:
            continue
        lines.append(
            f"| {t.arch} | {t.shape} | {t.mesh} | {t.mode} | {t.compute_s:.4g} "
            f"| {t.memory_s:.4g} | {t.collective_s:.4g} | {t.dominant} | {t.useful_ratio:.2f} "
            f"| {100 * t.roofline_fraction:.1f}% | {t.rank_gib:.2f} | {t.fits} "
            f"| {NOTES[t.dominant]} |"
        )
    return "\n".join(lines)


def splice(text: str, marker: str, payload: str) -> str:
    """``payload`` after ``<!-- marker -->``, closed by ``<!-- /marker -->``;
    a block a previous run closed is replaced."""
    tag, end = f"<!-- {marker} -->", f"<!-- /{marker} -->"
    if tag not in text:
        raise SystemExit(f"marker {marker} missing")
    block = f"{tag}\n\n{payload}\n\n{end}"
    old = re.compile(re.escape(tag) + r".*?" + re.escape(end), re.S)
    if old.search(text):
        return old.sub(lambda _: block, text, count=1)
    return text.replace(tag, block, 1)


def main(argv: Optional[Sequence[str]] = None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("target", help="the Markdown file holding the markers")
    ap.add_argument("--records", default="results/dryrun",
                    help="the directory of the dry-run's JSON records")
    args = ap.parse_args(argv)
    recs = load(args.records)
    with open(args.target) as f:
        text = f.read()
    text = splice(text, "DRYRUN_SUMMARY", dryrun_summary(recs))
    text = splice(text, "ROOFLINE_TABLE", roofline_table(recs))
    with open(args.target, "w") as f:
        f.write(text)
    print(f"rendered {len(recs)} records into {args.target}")
    return text


if __name__ == "__main__":
    main()
