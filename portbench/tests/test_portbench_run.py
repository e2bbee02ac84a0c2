"""Runs of the harness at tiny sizes on the CPU: a sound run, its modules,
and the faults and the control it has to find."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import control, harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELLS = ["miami-k3.u12-2", "rmat250-k8.u12-2"]
#: a mix of several templates (``Counter.estimate_many``'s sampler), on the
#: first cell's configuration
FAMILY = "family-k10"
SEED = 2**31 + 4242


def tiny(cell, mix=None):
    """The cell's spec on a graph the CPU holds; the mix (``batch`` and what
    the check compares) as committed."""
    spec = harness.cell_spec(cell)
    spec["config"] = dict(spec["config"], vertices=300, edges=3000)
    if mix is not None:
        with open(os.path.join(ROOT, "portbench", "mixes", mix + ".json")) as fh:
            spec["mix"] = json.load(fh)
    return spec


def run(cell, wrap=None, make_program=None, seconds=0.3, trace=False, mix=None, seed=SEED):
    return harness.run_cell(tiny(cell, mix), seed, seconds, trace, device="cpu", wrap=wrap,
                            make_program=make_program, log=lambda *a: None)


@pytest.mark.parametrize("cell,mix", [(c, None) for c in CELLS] + [(CELLS[0], FAMILY)])
def test_sound_run_is_correct(cell, mix):
    r = run(cell, mix=mix)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 2
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(r["metrics"]) == {"colorings_per_s", "peak_device_gib", "setup_s"}
    gap = r["checks"]["est_rel_gap"]
    assert 0 <= gap["value"] <= gap["limit"]


def test_traced_run_reads_what_the_cpu_has():
    r = run(CELLS[0], trace=True, mix=FAMILY)
    assert r["correct"]
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "breakdown",
                       "checks"]
    # no kernel runs on the CPU: the rooflines, idle share and launch counters stay silent
    assert set(r["metrics"]) == {"plan_build_s"}
    assert r["device"]["window_s"] > 0


class StaleState:
    """A call that returns the state of the call before it unchanged."""

    def __init__(self, program):
        self.program, self.last = program, None

    def __call__(self, key, batch):
        out = self.program(key, batch)
        if self.last is None:
            self.last = out
        return self.last


def half_batch(program):
    """Half of the batch left out, the mean taken over the rest."""
    def f(key, batch):
        out = program(key, batch)
        return np.repeat(out[: max(1, batch // 2)].mean(axis=0, keepdims=True), batch, axis=0)
    return f


def altered_answer(program):
    """One answer of each call altered where it is produced."""
    def f(key, batch):
        out = program(key, batch).copy()
        out[-1] *= 1.01
        return out
    return f


@pytest.mark.parametrize("fault", [StaleState, half_batch, altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_faults_come_out_not_correct(cell, fault):
    """At the mix's own batch and check, on every seed: the check compares
    a whole call, so a fault in any one slot of each call shows."""
    for seed in (SEED, SEED + 1, SEED + 2):
        r = run(cell, wrap=fault, seconds=0.5, seed=seed)
        assert not r["correct"] and r["failed"] > 0, seed


def test_check_covers_a_whole_call_and_another():
    mix = {"check_calls": 1, "check_colorings": 1}
    for seed in range(20):
        picks = harness.check_picks(7, 4, mix, seed)
        calls = sorted({c for c, _ in picks})
        assert len(picks) == 5 and len(calls) == 2
        assert any(sorted(b for c, b in picks if c == call) == [0, 1, 2, 3] for call in calls)
    assert harness.check_picks(1, 4, mix, 3) == [(0, 0), (0, 1), (0, 2), (0, 3)]


@pytest.mark.parametrize("cell", CELLS)
def test_control_comes_out_not_correct(cell):
    """The reference in bfloat16 in the program's place fails the cell's
    own limit (on the chip: ``control.py`` at the cell's size)."""
    r = run(cell, make_program=control.ReferenceProgram, seconds=0.0)
    gap = r["checks"]["est_rel_gap"]
    assert not r["correct"] and gap["value"] > gap["limit"]


def test_reference_program_in_float64_passes():
    """The same stand-in at the reference's own precision is correct: the
    control fails by its precision alone."""
    make = lambda g, m, d: control.ReferenceProgram(g, m, d, dtype=torch.float64)
    r = run("miami-k3.u12-2", make_program=make, seconds=0.0)
    assert r["correct"] and r["checks"]["est_rel_gap"]["value"] < 1e-12


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import json, sys\n"
        "sys.path[:0] = [{root!r}, {src!r}]\n"
        "from portbench import harness\n"
        "spec = harness.cell_spec('miami-k3.u12-2')\n"
        "spec['config'] = dict(spec['config'], vertices=200, edges=1500)\n"
        "r = harness.run_cell(spec, 5, 0.2, False, device='cpu', log=lambda *a: None)\n"
        "print(json.dumps({{'bad': harness.forbidden_modules(), 'correct': r['correct'],\n"
        "                  'mods': sorted({{m.split('.')[0] for m in sys.modules}})}}))\n"
    ).format(root=ROOT, src=os.path.join(ROOT, "src"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"]
    assert line["bad"] == []
    assert "repro_torch" in line["mods"]
    assert not {"jax", "jaxlib", "flax", "repro"} & set(line["mods"])


def test_run_py_refuses_without_a_card(tmp_path):
    """No CUDA device: a code other than 0 and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "miami-k3.u12-2",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_run_py_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "miami-k3.u12-2",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
