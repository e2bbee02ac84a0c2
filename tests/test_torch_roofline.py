"""The roofline and the kernels' work counts, on the CPU.

* ``kernels.work`` at the main cell's shapes (u12-2, R-MAT 2^20 with
  19,985,166 directed edges, B = 4; the dense cell: R-MAT 2^16 with
  29,426,902 edges in 262,144 patches, B = 16) gives ``PERF.md`` §6's bound
  column for one pass: 24.9 ms (edge SpMM), 32.1 (combine), 32.4 (fused),
  34.6 (block), each within 0.1 ms, and flash's 0.556 at the prefill's
  launch;
* ``analyze_record``'s terms for hand-written records, against the H100's
  rates; ``analyze_dir`` over the records ``_emit`` wrote;
* the dry-run CLI for every ``COUNTING_CONFIGS`` row, single- and
  multi-pod, with ``memory``, ``cost``, ``collectives``, ``compaction``
  and ``routing``; a run in a fresh process loads no JAX and no ``repro``.
"""

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.configs.subgraph import COUNTING_CONFIGS
from repro_torch.core.table_program import build_node_tables
from repro_torch.core.templates import partition_tree, template
from repro_torch.kernels import work
from repro_torch.launch import dryrun
from repro_torch.roofline import analysis

ROOT = Path(__file__).resolve().parents[1]

#: the main cell's graph (chip_smoke.py phase 4, as its log reports it)
MAIN = dict(n_pad=1_048_704, edges=19_985_166, batch=4)
#: the dense cell's (phase 5): 2^16 vertices, its block plan's patches
DENSE = dict(n_pad=65_664, edges=29_426_902, patches=262_144, batch=16)


def _u12_nodes():
    """u12-2's internal nodes at k = 12: each node's split tables."""
    chain = partition_tree(template("u12-2"))
    combine, widths = build_node_tables(chain, 12, device=torch.device("cpu"))
    return [(combine[i], widths[nd.right]) for i, nd in chain.internal_nodes()]


def _pass_ms(works):
    return sum(analysis.bound_s(w)[0] for w in works) * 1e3


def test_work_counts_give_perf_bound_column():
    n, e, b = MAIN["n_pad"], MAIN["edges"], MAIN["batch"]
    nodes = _u12_nodes()
    assert len(nodes) == 11
    edge = _pass_ms(work.spmm_edge(n, n, e, b * w) for _, w in nodes)
    comb = _pass_ms(work.color_combine(n * b, t.a, t.w, t.s, t.j, t.jp) for t, _ in nodes)
    fused = _pass_ms(work.fused_count(n, n, e, b, t.a, t.w, t.s, t.j, t.jp) for t, _ in nodes)
    nd, ed, pd, bd = DENSE["n_pad"], DENSE["edges"], DENSE["patches"], DENSE["batch"]
    block = _pass_ms(work.spmm_block(nd, pd, ed, bd * w) for _, w in nodes)
    assert edge == pytest.approx(24.9, abs=0.1)
    assert comb == pytest.approx(32.1, abs=0.1)
    assert fused == pytest.approx(32.4, abs=0.1)
    assert block == pytest.approx(34.6, abs=0.1)
    # which term binds: bytes for the three main-cell kernels, adds for the block SpMM
    assert analysis.bound_s(work.spmm_block(nd, pd, ed, bd * 792))[1] == "operations"
    assert analysis.bound_s(work.spmm_edge(n, n, e, b * 792))[1] == "bytes"
    flash = work.flash_attention(4, 32, 8, 4096, 128, 2, causal=True, window=0)
    assert analysis.bound_s(flash) == (pytest.approx(0.556e-3, abs=1e-6), "operations")


#: (B, Hq, Hkv, L, D, window): granite-3-8b's prefill launch and
#: recurrentgemma-2b's local layers, both causal
FLASH_SHAPES = {"granite": (4, 32, 8, 4096, 128, 0), "recurrentgemma": (2, 10, 1, 4096, 256, 2048)}


@pytest.mark.parametrize("itemsize", [4, 2], ids=["float32", "bf16"])
@pytest.mark.parametrize("shape", FLASH_SHAPES)
def test_flash_work_prices_float32_on_the_cuda_cores(shape, itemsize):
    """A float32 launch is ``2 D`` FMAs an allowed pair at the CUDA cores'
    33.5e12 a second (8.21 ms at granite's shape, 1.92 at recurrentgemma's);
    a bf16 launch ``4 D`` tensor-core flops at 989e12, as before."""
    b, hq, hkv, l, d, w = FLASH_SHAPES[shape]
    pairs = work.attention_pairs(l, True, w)
    assert pairs == {"granite": 8_390_656, "recurrentgemma": 6_292_480}[shape]
    got = work.flash_attention(b, hq, hkv, l, d, itemsize, True, w)
    assert got.bytes == (2 * b * hq + 2 * b * hkv) * l * d * itemsize
    t, by = analysis.bound_s(got)
    if itemsize == 4:
        assert got.fmas == 2 * b * hq * pairs * d and got.bf16_flops == 0 == got.adds
        assert got.flops == 2 * got.fmas and by == "operations"
        assert t * 1e3 == pytest.approx({"granite": 8.21, "recurrentgemma": 1.92}[shape],
                                        abs=5e-3)
    else:
        assert got.bf16_flops == 4 * b * hq * pairs * d == got.flops and got.fmas == 0
        assert t * 1e3 == pytest.approx({"granite": 0.556, "recurrentgemma": 0.1303}[shape],
                                        abs=1e-3)


def test_work_arithmetic():
    w = work.spmm_edge(10, 20, 30, 4)
    assert w == work.Work(bytes=(20 + 10) * 4 * 4 + 11 * 8 + 30 * 4, adds=120)
    c = work.color_combine(10, 3, 4, 5, 2, 4)
    assert c == work.Work(bytes=10 * 12 * 4 + 5 * 4 * 4, fmas=100)
    assert (w + c).flops == 120 + 200 and (w + c).bytes == w.bytes + c.bytes
    f = work.fused_count(10, 20, 30, 2, 3, 4, 5, 2, 4)
    assert f.bytes == (10 * 8 + 20 * 4) * 2 * 4 + 11 * 8 + 30 * 4 + 5 * 4 * 4
    assert (f.adds, f.fmas) == (30 * 2 * 4, 10 * 2 * 5 * 2)
    assert work.attention_pairs(5, True, 0) == 15 and work.attention_pairs(5, False, 0) == 25
    assert work.attention_pairs(5, True, 2) == 9 and work.attention_pairs(4, False, 2) == 13


def _rec(**kw):
    rec = {"arch": "counting:x", "shape": "u12-2", "mesh": "16x16", "mode": "ring",
           "status": "ok", "chips": 256, "data_ranks": 16,
           "memory": {"argument_bytes": 10e9, "output_bytes": 512, "temp_bytes": 60e9},
           "cost": {"flops": 4e12, "fp32_ops": 3.35e12, "bytes_accessed": 6.7e12},
           "collectives": {"all-to-all": 1e9, "collective-permute": 4e9, "ops": {"x": 3}}}
    rec.update(kw)
    return rec


def test_terms_read_the_h100():
    t = analysis.analyze_record(_rec(), hbm_bytes=80e9)
    assert t.compute_s == pytest.approx(0.1)  # 3.35e12 float32 adds and FMAs at 33.5e12/s
    assert t.memory_s == pytest.approx(2.0)  # 6.7e12 bytes at 3.35e12 B/s
    # 16 data ranks cross hosts: the inter-host link, 400 Gb/s a card
    assert t.collective_s == pytest.approx(5e9 / 50e9)
    assert t.dominant == "memory" and t.fits and t.rank_gib == pytest.approx(70e9 / 2**30, 1e-6)
    assert t.roofline_fraction == pytest.approx(0.05)
    assert not analysis.analyze_record(_rec(), hbm_bytes=64e9).fits
    nv = analysis.analyze_record(_rec(data_ranks=8), hbm_bytes=80e9)
    assert nv.collective_s == pytest.approx(5e9 / 450e9)  # NVLink within one host
    cal = analysis.analyze_record(_rec(), hbm_bytes=80e9, beta=1e-9)
    assert cal.collective_s == pytest.approx(5.0)  # a measured link: 1 GB/s
    lm = analysis.analyze_record(_rec(arch="granite-3-8b", kind="prefill", global_batch=4,
                                      seq_len=4096, params=8e9,
                                      cost={"flops": 989e12, "bytes_accessed": 0.0}),
                                 hbm_bytes=80e9)
    assert lm.compute_s == pytest.approx(1.0) and lm.model_flops == 2 * 8e9 * 4 * 4096
    assert analysis.analyze_record({"status": "error"}) is None
    # where no card is present, "fits" is against the data sheet's 80 GB
    if not torch.cuda.is_available():
        assert analysis.device_memory_bytes() == 80e9
    # (the inter-host link, 400 Gb/s NDR a card, is not in the list: its
    # data sheet rate happens to equal a TPU link's assumed one)
    for name in ("HBM_BYTES_PER_S", "FP32_OPS_PER_S", "BF16_FLOPS_PER_S", "HBM_BYTES",
                 "NVLINK_BYTES_PER_S"):
        assert getattr(analysis, name) not in (197e12, 819e9, 50e9, 25e9, 16 * 2**30), name


def test_no_tpu_constant_in_the_roofline():
    text = (ROOT / "src" / "repro_torch" / "roofline" / "analysis.py").read_text()
    for tpu in ("197e12", "819e9", "50e9", "25e9", "16 GiB", "hbm_gib"):
        assert not re.search(r"(?<![\d.])" + re.escape(tpu), text), tpu


@pytest.mark.parametrize("multi_pod", [False, True], ids=["pod", "two-pods"])
@pytest.mark.parametrize("row", sorted(COUNTING_CONFIGS))
def test_every_row_dry_runs(row, multi_pod, tmp_path, capsys):
    assert dryrun.main(["--counting", row, "--out", str(tmp_path)]
                       + ["--multi-pod"] * multi_pod) == 0
    (path,) = tmp_path.glob("*.json")
    rec = json.loads(path.read_text())
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert rec["status"] == "ok" and rec["chips"] == (512 if multi_pod else 256)
    assert rec["mode"] == COUNTING_CONFIGS[row].mode and "analysis_s" in rec
    for key in ("memory", "cost", "collectives", "compaction", "routing", "launches"):
        assert key in rec
    mem = rec["memory"]
    assert mem["argument_bytes"] > 0 and mem["temp_bytes"] > 0 and mem["output_bytes"] > 0
    assert rec["cost"]["flops"] > 0 and rec["cost"]["bytes_accessed"] > 0
    assert (rec["compaction"] is not None) == COUNTING_CONFIGS[row].compact
    assert set(rec["collectives"]["ops"]) == set(rec["collectives"]) - {"ops"}
    assert sum(rec["launches"].values()) > 0
    t = analysis.analyze_record(rec, hbm_bytes=80e9)
    assert t.dominant in ("compute", "memory", "collective") and t.step_s > 0


def test_analyze_dir_reads_emitted_records(tmp_path):
    for mode in ("alltoall", "pipeline", "ring"):
        dryrun.run_counting_cell("rmat500-u12-2", False, str(tmp_path), mode)
    dryrun.run_counting_cell("bench-sparse", True, str(tmp_path))
    (tmp_path / "broken.json").write_text(json.dumps({"status": "error", "arch": "x"}))
    terms = analysis.analyze_dir(str(tmp_path), hbm_bytes=80e9)
    assert [t.mode for t in terms] == ["adaptive", "alltoall", "pipeline", "ring"]
    by_mode = {t.mode: t for t in terms}
    # Eq. 7 against Eq. 12: alltoall holds all P received chunks at once
    assert by_mode["alltoall"].rank_gib > 2 * by_mode["pipeline"].rank_gib
    table = analysis.format_table(terms)
    assert table.count("\n") == len(terms) + 1 and "rmat500-u12-2" in table
    assert all(math.isfinite(t.step_s) for t in terms)


def test_cli_loads_no_jax():
    code = ("import sys; from repro_torch.launch import dryrun; "
            "rc = dryrun.main(['--counting', 'bench-small']); "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad); sys.exit(rc or (1 if bad else 0))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
