"""The control of the benchmark's correctness check, on the chip.

    python3 portbench/control.py --workload <cell> --seed <n> [--seed <n> ...]

Runs the cell as ``run.py`` does, with the program replaced by the plain
reference computed in bfloat16 (``reference/colorcoding.py`` with
``dtype=torch.bfloat16``: every table stored in bf16, each operation's
result rounded to it): the step below the float32 tables the port keeps.
One call makes the window (the control is slow), every coloring of it is
judged against the float64 reference, and the line printed for each seed
has to read ``"correct": false``.  The benchmark's own runs never run it.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # as run.py

import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import harness  # noqa: E402
from portbench.frozen import threefry  # noqa: E402
from portbench.reference import colorcoding  # noqa: E402


class ReferenceProgram:
    """The reference in ``dtype`` behind the program's calling convention."""

    plan_build_s = 0.0

    def __init__(self, graph, mix, device, dtype=torch.bfloat16):
        self.n, self.mix, self.device = graph["n"], mix, device
        self.k = int(mix["n_colors"])
        self.graph = colorcoding.Graph(graph["n"], graph["indptr"], graph["indices"], device,
                                       dtype)

    def __call__(self, key, batch):
        colorings = threefry.draw_colorings(key, self.n, self.k, batch, device=self.device)
        return np.array([colorcoding.estimates(self.graph, self.mix["templates"], c, self.k)
                         for c in colorings], np.float64)

    def node_sizes(self):
        return []


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    for seed in args.seed:
        t0 = time.perf_counter()
        r = harness.run_cell(spec, seed, 0.0, False, device=args.device,
                             make_program=ReferenceProgram)
        print(json.dumps({"seed": seed, "correct": r["correct"], "checks": r["checks"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
