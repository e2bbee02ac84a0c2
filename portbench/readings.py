"""The program's readings that a cell's correctness limit is set from, on the chip.

    python3 portbench/readings.py --workload <cell> --seconds <s> --seed <n> [--seed <n> ...]

A configuration's graph does not depend on the run's seed, so one process
makes the graph and builds the program once, as ``run.py``'s set-up does,
and then, for each seed, runs a window of ``--seconds`` of the timed calls
with that seed's keys and checks it as a run does (every coloring of the
mix's ``check_calls`` calls and ``check_colorings`` more, against the
float64 reference).  One line a seed: its gap beside the cell's limit, the
gap of each checked coloring, and its rate over that short window.  The
lower reading of the cell's limit is the largest gap over a dozen seeds or
more; ``control.py`` gives the upper one.  The benchmark's own runs never
run it.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]
os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"  # as run.py

import json  # noqa: E402
import time  # noqa: E402

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, action="append", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    spec = harness.cell_spec(args.workload)
    mix = spec["mix"]
    batch = int(mix["batch"])
    dev = torch.device(args.device)
    t0 = time.perf_counter()
    graph = harness.make_graph(spec["config"], dev)
    program = harness.Program(graph, mix, args.device)
    program(harness.threefry.fold_in(harness.base_key(args.seed[0]), 0), batch)
    print(json.dumps({"graph": graph["stats"], "setup_s": time.perf_counter() - t0,
                      "plan_build_s": program.plan_build_s}), flush=True)
    for seed in args.seed:
        win = harness.run_window(program, harness.base_key(seed), harness.WARM_CALLS, batch,
                                 args.seconds, dev, False)
        check = harness.check_answers(spec, graph, win, seed, dev)
        print(json.dumps({"seed": seed, "calls": len(win["answers"]),
                          "colorings_per_s": len(win["answers"]) * batch / win["window_s"],
                          "peak_device_gib": win["peak_bytes"] / harness.GIB,
                          "checks": check["checks"], "gaps": check["gaps"],
                          "reference_s": check["reference_s"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
