#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA card, end to end:
the single-device tree-template estimate, family counting, treewidth-2 bag
programs, active-frontier compaction, the distributed exchange engine on
thread ranks sharing the card (dense, compacted and at narrow wires), the
resident counting service, the counting dry-run's memory model held
against those runs, the granite-3-8b serving path (prefill, then decode),
the other six LM rows served at full width (vision cross-attention,
experts with the distributed expert layer, RWKV6, RG-LRU with local
attention at head dim 256, the whisper encoder-decoder) and training
(smollm-360m whole, a phi3.5-moe layer, the int8 gradient ring) and the
LM on a data x model mesh (training, serving, experts, torchrun) and on the
multi-pod mesh beside the LM dry-run's memory model, with
every kernel of their paths built from this checkout and held against its
plain PyTorch version.  Every bound is the roofline of a kernel's work count
(``repro_torch.kernels.work``).

    python3 chip_smoke.py            # all phases, one card (about 13-16 minutes)

Phases (each raises on failure; the exit code is 0 only if all pass):

1. build   — compile the six CUDA kernel libraries with nvcc (sm_90a), in
             parallel; the SASS must hold what each redesigned library's
             design rests on: HGMMA (wgmma) and UTMALDG (TMA loads) in the
             bf16 flash library, LDGSTS (its cp.async ring) and FFMA in the
             float32 flash library, which must hold no HMMA or HGMMA (its
             products stay float32 FMAs), UBLKCP (bulk asynchronous copies) and
             LDGSTS (cp.async) in spmm_block's, LDG.E.128 in spmm_edgetile's,
             LDG.E.128 (16-byte staging loads and, in fused_count, gathers),
             LDS.128 (the split entries' broadcast) and LDGSTS (their
             cp.async prefetch) in color_combine's and fused_count's;
2. kernels — each kernel against its plain version at its path's shapes
             (every u12-2 node width), exact (==) on integer tables whose
             sums stay below 2^24; timed beside the plain version, a library
             call where one exists, and its bound; the edge SpMM also on a
             CSR whose ten largest rows are cut.  The edge SpMM, combine
             and fused kernels run on the main cell's graph; the block SpMM
             on the dense cell's, where it is held == the plain edge-list
             sum and == spmm_edgetile on the whole graph, and == its own
             dense-patch plain version on a sample of row blocks.  The
             combine and fused kernels also at u14's and u15-2's widest
             nodes on a small R-MAT graph.  On each cell, a table near 2^22
             whose sums round: spmm_edgetile == the sequential float32 sum
             in CSR order, on the main cell fused_count ==
             color_combine(spmm_edgetile), and on the dense cell spmm_block
             == spmm_edgetile, bitwise;
3. exact   — small graphs, templates u3-1/u5-2/u7-2 and the treewidth-2 rows
             cycle3-cycle6, diamond, bowtie and house, a fixed coloring: the
             port on the card, edge and block plans, fused and unfused, ==
             the brute-force oracle; the trees again on compacted plans
             (R-MAT 512 / 600, density_threshold 1.0, the profitability
             floors forced down), whose checked counts == brute force;
4. main    — the main path at full width: u12-2 on R-MAT 2^20 vertices / 10M
             edges (skew 3, relabeled), count_fn unfused and fused; maps of
             the two bitwise equal, launch counts as the plan predicts, one
             coloring through the plain versions on the card within rtol
             1e-5, fused peak memory below unfused;
5. dense   — Counter.estimate on the dense cell: u12-2 on R-MAT 2^16 / 16M
             (average degree 449), spmm_kind="auto" plans the block format;
             its per-coloring samples == those of spmm_kind="edges" for the
             same key, bitwise; launch counts as the plan predicts; one
             coloring through the plain versions within rtol 1e-5;
6. launch  — the launcher: bench-small with and without --fuse prints
             identical estimates; --checkpoint-dir then --resume prints the
             same estimate; --fuse --spmm-kind auto on a dense --graph file
             reports kind=edges and fuse=True; --config bench-family prints a
             u5-2 line == --templates u5-2,u7-2's (same key, k = 7) ==
             Counter.estimate(n_colors=7); --config bench-cycles and
             bench-tw2-mixed run, fused and unfused printing the same;
             --config bench-sparse (compacted) reports engaged caps and
             prints the estimates of --density-threshold -1 (none engaged);
7. flash   — the bf16 flash-attention kernel (wgmma) against its plain
             version at the shape granite-3-8b's prefill launches it (B=4,
             Hq=32, Hkv=8, L=4096, D=128, causal), within one bf16 step of the
             plain version's float32 result rounded (plus 1e-6 near zero: both
             sum in float32, in other orders); timed beside the plain version,
             scaled_dot_product_attention (a yardstick only, whose own distance
             from the plain version under the same gate is logged) and its
             bound; the float32 kernel (CUDA cores) at the same shape within
             1e-5, timed the same way against its bound at the CUDA cores'
             float32 rate; its geometry (tile rows, ring slots, shared memory)
             == the host's mirror, and its tiles' edges within 1e-5: L one past
             a query tile (129 at D = 128, 65 at D = 256), GQA groups 1 and 8,
             D = 64 with window 300; also B=1, D=64 with window 1024,
             bidirectional, ragged L (1, 127, 128, 1000, 4097) and GQA groups
             1, 2, 4 and 8; at D = 256 (64-key KV tiles) both kernels at
             recurrentgemma-2b's local-attention launch (B=2, Hq=10, Hkv=1,
             L=4096, causal, window 2048) under the same gates, timed beside
             the plain version, SDPA (the window as a boolean mask) and the
             bound, and ragged L (1, 127, 1000) and bidirectional;
8. lm      — granite-3-8b at full width and depth (40 layers, bf16 weights from
             a seed): one warm and two timed prefills of B=4 prompts of 4096
             tokens, then 32 greedy decode steps with finite logits; 40
             launches of the bf16 kernel per prefill; on the same weights in
             float32 (the float32 kernel), the first
             decode step's logits == a forward over the 4097 tokens at the last
             position within 2e-2 (the reference's own tolerance); in bf16, the
             first decode step no more than 1.5x as far from that float32
             forward as the bf16 forward is; and a 2-layer full-width granite
             in float32 (L=256) whose prefill on the card == the CPU's on the
             same weights within 1e-4 relative.  The launches of the served
             path (the three prefills and the decode steps) and those of the
             float32 checks are counted apart, as paths "lm" and
             "lm_float32_checks";
9. family  — the rmat500-family row's templates u5-2, u7-2, u10-2 at k = 10 on
             the main cell's graph, B = 8: the kernels against their plain
             versions at every node shape of the shared DAG (exact), then
             count_fn_many unfused and fused, 2 calls each: maps bitwise
             equal, launches as the DAG predicts (a node one SpMM and one
             combine, or one fused launch), each template's own plan with
             n_colors = 10 on the same colorings (bitwise logged, held
             within rtol 1e-5), one coloring through the plain versions
             within rtol 1e-5, ms per coloring, peak bytes and the family
             batch beside the three single-template runs (path "family");
10. tw2    — the bench-tw2-mixed row's family (u3-1, cycle4, u5-2, cycle6,
             diamond) at k = 6 on R-MAT 2^13 / 64,000, B = 2: as phase 9, with
             the bag nodes' SpMM on [n_pad, B, x W] tables and combine on
             [n_pad, B x, W] views (2.73e9 elements at W = 20) held against
             their plain versions a block of rows at a time; tree nodes fused,
             bag nodes never (a bag_combine one SpMM and one combine, a
             collapse none); then Counter.estimate of cycle6 alone on the
             same graph, whose samples equal the family's cycle6 column
             (path "tw2");
11. sparse — active-frontier compaction on the rows that set it, u10-2 at
             R-MAT 2^22 vertices, B = 2: rmat-sparse-u10-2 (2,097,152 edges,
             skew 3, threshold 0.25) and bench-sparse's shape (6,144,000
             edges, skew 8, threshold 0.5).  The spec (densities, caps) and
             the probe's seconds; at an engaged node each, on the DP's own
             active rows, the edge SpMM and the fused kernel on a compact
             source through remapped columns and the combine on gathered
             rows == their plain versions (exact) and == their dense runs;
             count_fn compacted and its dense twin, unfused and fused, 2
             calls each: maps bitwise equal, the compact routes and the
             launches as the spec predicts, the per-coloring flags and
             fallbacks, ms per coloring and peak bytes side by side; one
             call under the compaction.overflow fault runs the dense twin
             on the card and == it (path "sparse");
12. distributed — the exchange engine (repro_torch.core.distributed) on
             LocalMesh thread ranks sharing the card.  (a) exact: the
             reference worker's ER(97, 5) and a skew-8 R-MAT (4096 / 1200),
             p4, sp21 and u5-2, LocalMesh 4 x 1 and 8 x 2, every
             mode (alltoall, pipeline g 1 and 3, adaptive, ring) x fuse ==
             brute force; the families u3-1/u5-2/u7-2, cycle4, diamond and a
             mixed one == the single-device port; keyed samples P = 1 ==
             P = 8.  (b) full width: u12-2 on the main cell's graph,
             LocalMesh P = 4, B = 1, every mode x fuse, a warm then a timed
             call: counts within rtol 1e-5 of the single-device port on the
             same coloring (bitwise logged), ms per coloring and peak bytes
             per mode, launches as the routes predict (path
             "distributed"); at u12-2's (12, 220, 495, 4) node the edge and
             fused kernels on shard 0's rectangular alltoall CSR and on a
             bucket CSR, and the combine on the shard's rows, == their plain
             versions, timed.  (c) an NCCL group of world size 1 (TCPStore
             on localhost): every mode == LocalMesh P = 1; calibrate on
             LocalMesh P = 4 (alpha, beta beside the card's name).  (d) the
             launcher: --config bench-small --mode adaptive at --shards 2
             and 4 print identical estimates, within the RSD of --mode
             single;
13. compact — the compacted exchange and the narrow wire of the same
             engine.  (a) exact: phase 12 (a)'s graphs and trees on LocalMesh
             P = 4 (floors forced down, threshold 1.0), alltoall, pipeline
             g1 and ring x fuse x wire (float32, int16, int8) x {dense,
             compact} == brute force on
             its own rung; storms of compression.saturate and
             compaction.overflow give the same counts.  (b) full width:
             phase 11's two rows at 2^22 (u10-2), P = 4, B = 2, alltoall,
             pipeline g1 and ring, unfused and fused, at float32 dense,
             float32 compact and int16 compact, a warm then a timed call:
             compact == dense and int16 == float32 bitwise, all within rtol
             1e-5 of the single-device count; ms per coloring, peak bytes,
             node_exchange_bytes per exchanged node, the spec and the rung
             each call ended on; launches as the rungs predict (path
             "distributed_compact"); the kernels against their plain
             versions at the widest compacted node's shapes.  (c) phase 12
             (b)'s u12-2 plan at alltoall, int16 against float32: the rung
             reached and the time.  (d) NCCL at world size 1 (phase 12 (c)'s
             world): int16 and int8 payloads as bytes, every narrow count
             call == LocalMesh P = 1; the launcher's bench-sparse --mode
             pipeline --shards 4 --compact --wire-dtype int16 prints the
             estimates of --wire-dtype float32 with no node engaged;
14. serve  — the counting service (repro_torch.serve) on the main cell's
             graph, bench-service's script (k = 7, batch 8, tenants alice,
             bob and carol, u3-1, u5-2 and u7-2, repeated twice).  First
             each kernel against its plain version at every node shape of
             the union family plan u3-1/u5-2/u7-2 at k = 7, batch 8 (the
             shapes of every plan the service builds in (a)).  (a)
             run_until_idle unfused then fused: every done ticket == the
             solo Counter.estimate / estimate_many with the same key and
             batch, bitwise, fused == unfused, launches as the dispatches'
             family programs predict (path "serve"); plan build seconds a
             cache miss, ms a pass call (median, the service's EWMA),
             request latency p50 and max, host overhead a pass call (step
             less dispatch and plan builds), coalescing and hit rate; the
             unfused run again under the profiler (busy share).  (b) the
             driver thread, one client thread a tenant: == (a) bitwise.  (c)
             a cancel mid-stream and an expired deadline (virtual clock):
             co-riders == solo, the cancelled ticket's checkpointed state
             resumes through estimate_many to the uninterrupted result.  (d)
             plan_cache_capacity=1, families A, B, A: after two evictions the
             allocated bytes == A's plan alone, and with the service gone ==
             before the first build, within 1 MiB.  (e) at bench-small:
             service.pass_poison quarantines one call of one pass,
             service.step_crash is recorded and the driver goes on,
             service.slow_pass past timeout_s retries at the same key ==
             solo.  (f) the distributed backend on LocalMesh P = 4: every
             ticket == the solo distributed estimate bitwise, and every
             call of every ticket within 1e-5 of the single-device union
             plan on the same colorings.
             (g) the launcher: bench-service and --threaded print identical
             estimates; smoke-service --backend distributed runs.
15. dryrun — the counting dry-run (repro_torch.launch.dryrun: one rank's
             program on meta tensors at paper scale) and the roofline
             (repro_torch.roofline.analysis).  (a) the dry-run CLI for every
             COUNTING_CONFIGS row at its production mesh (friendster-u12-1
             multi-pod too), and rmat500-u12-2 at
             alltoall, pipeline and ring, in
             processes that see no card: per-rank argument and temp bytes,
             fits on this card, the dominant roofline term; any error record
             fails.  (b) the model of each phase 12 (c) NCCL call at world
             size 1 within 5% of its max_memory_allocated growth.  (c) the
             model of phase 12 (b)'s LocalMesh P = 4 u12-2 cell, every mode x
             fuse: the split tables once, the four ranks' arguments and
             settled bytes (held between ops) and one rank's excess over
             them, within 15% of the peak over the warm and timed calls; the
             alltoall / pipeline ratio within 10%.
             (d) no kernel time of phases 2-14 below the bound its work count
             (repro_torch.kernels.work) gives.
16. lm-rows — the six other rows at full width, bf16 weights from a seed
             (``xgate`` drawn nonzero), depth cut to fit the card:
             llama-3.2-vision-90b 5 layers (one pattern group, B=2 x 4096
             over 1600 image tokens), whisper-base whole (B=4 x 448 over
             1500 frames), phi3.5-moe 4 layers (B=4 x 4096), mixtral-8x22b 2
             layers (B=2 x 6144, past its 4096 window: windowed flash and a
             wrapped cache), rwkv6-3b whole (B=4 x 4096), recurrentgemma-2b
             whole (B=2 x 4096; local attention at D = 256).  Per row one
             warm and two timed prefills, 32 greedy decode steps with finite
             logits, prefill ms and tokens/s, decode ms a step, peak bytes,
             flash launches per prefill as the pattern predicts
             (self-attention, local and encoder layers); on a 31-token
             prompt (MoE at a capacity that drops nothing) the float32
             decode step over a float32 cache == a forward over 32 tokens
             within 2e-2 (over the reference's bf16 cache its distance is
             logged: the cache's rounding alone passes 2e-2 at llama's
             width) and the bf16 decode step within 1.5x the bf16
             forward's distance from it; each block kind's first layer (whisper's encoder whole) in
             float32 on the card == the CPU within 1e-4 relative (path
             "lm_rows", its checks "lm_rows_float32_checks").  (b)
             moe_block_manual on LocalMesh P = 4 sharing the card, one
             full-width float32 layer at the capacity that drops nothing:
             phi3.5 EP fused, pipelined (grouped_exchange) g1 and g2, the
             replicated-token fallback at a decode batch of 3, mixtral TP,
             each == moe_block within 2e-4, timed, with peak bytes.
17. train  — training, through no kernel (self-attention trains through
             chunked_attention, as the reference trains through its XLA
             path; every kernel's launch count stays put).  (a) smollm-360m
             whole (32 layers, d = 960), B = 8 x 2048 tokens of the
             synthetic stream, bf16 compute over float32 weights and AdamW
             state, remat "full": ``train`` for 2 warm and 4 timed steps
             and 2 more; finite losses whose last four average below the
             first, a finite gradient norm; ms a step, tokens/s, peak
             bytes, the model-flops share; one more step under the
             profiler (device time by kind) and its parts alone (chunked
             attention, the chunked CE, AdamW); then at full width cut to
             2 layers, 5 steps with a checkpoint after the third, and a
             fresh ``train`` resumes from it and takes the last 2 steps:
             weights == the uninterrupted run's within 1e-6 relative.
             (b) phi3.5-moe at full width, one layer (1.56B
             parameters), B = 4 x 2048, 4 steps: every expert-layer call's
             aux loss finite and positive, every expert's and the router's
             AdamW moment moved, ms a step, peak bytes.  (c) each row's
             reduced config and smollm-360m whole (B = 1 x 256), float32:
             loss and gradients on the card == the CPU's within 1e-4
             relative.  (d) the int8 gradient ring on LocalMesh P = 4 over
             64M float32 elements a rank == the same ring on the CPU,
             bitwise, timed (path "train").
18. mesh   — the LM on a data x model mesh of LocalMesh thread ranks
             sharing the card, taking turns at host code, a wait past
             120 s failing the phase.  (a) smollm-360m whole on 2 x 2
             (FSDP, ZeRO-1), bf16, phase 17 (a)'s weights, stream and
             schedule, 2 warm and 1 timed step: losses within 1e-3
             relative of phase 17 (a)'s; each rank's weight, gradient, m
             and v elements == the specs' arithmetic; ms a step, tokens/s,
             peak bytes, the last warm step under the profiler (busy share;
             the backward of four thread ranks completes); float32 at 2
             layers: loss and gradient norm == one device's within 1e-5,
             each gathered gradient leaf within 1e-4 of its largest entry.
             (b) granite-3-8b whole on 1 x 4 (tensor-parallel), phase 8's
             weights and prompts: prefill (the bf16 flash kernel once a
             layer a rank on the rank's 8 q and 2 KV heads, 160 launches a
             prefill, path "lm_mesh") and 32 decode steps on the
             sequence-sharded bf16 cache; the bf16 decode step after phase
             8's first token within 1.5x the bf16 forward's distance from
             phase 8's float32 forward; at 4 layers, float32 over a
             float32 cache, the meshed decode step == a forward within
             2e-2 ("lm_mesh_float32_checks"); a rank's flash launch ==
             its plain version under the flash gate, timed; prefill ms,
             tokens/s, decode ms a step, each rank's weight elements ==
             the specs'.  (c) phi3.5-moe at full width cut to 1 layer on
             2 x 2 (FSDP, EP), bf16, fused and pipelined: every rank's
             expert weights its specs' share, aux finite, ms a step,
             peak; the six mesh rows reduced, float32 on 2 x 2: card ==
             the CPU's meshed run within 1e-4.  (d) launch/train.py
             --distributed under torchrun at world size 1 (NCCL) == the
             same training on a 1 x 1 LocalMesh, bitwise.
19. rows   — the four other rows served on their meshes (recurrentgemma-2b
             anchored on 2 x 2, rwkv6-3b at 16 of its 32 layers,
             llama-3.2-vision at 5 layers and whisper-base on 1 x 4): prefill
             and decode ms (16 greedy steps; rwkv6-3b's depth and the steps
             cut for the script's time), flash shapes
             as predicted; each reduced row card == the CPU's meshed run
             (smollm-360m with sequence parallelism and FSDP); a rank's
             launch at each new flash shape (path "lm_mesh_rows").
20. pod    — the production and multi-pod meshes.  (a) the LM dry-run
             (``launch.dryrun.measure_lm`` on meta, in a process that sees
             no card, started with phase 1) of the cells phases 8, 17 (a),
             18 (a), (b) and 20 (b) run, held against their peaks: the
             one-rank cells within 5%, the LocalMesh cells inside [every
             rank at its fullest wait, the others there while one peaks]
             + 15% (with what the process holds beside the ranks:
             the phase's allocation before it, the whole weights while the
             ranks cut theirs).  (b) smollm-360m whole on (pod 2, data 1,
             model 2) thread ranks with the sharding ``launch/train.py
             --production-mesh --multi-pod`` builds (the batch over pod and
             data, seq_axis="model"), bf16, 2 warm and 1 timed step: losses
             within 1e-3 of phase 17 (a)'s, a rank's weight and ZeRO-1
             elements == the specs', ms a step, tokens/s, peak.  (c) the six
             attention rows reduced (head dim 64), float32, on (2, 2, 2):
             the loss, a prefill and 4 decode steps on the card == the
             CPU's meshed run within 1e-4 (the float32 flash kernel, path
             "lm_pod_checks").
21. examples — the port's three examples through their ``main``.  (a)
             examples/torch_quickstart.py at its own sizes on the card and
             on the CPU: the estimate's and the family's samples bitwise
             equal, a fixed coloring's count == brute force; (b)
             examples/torch_count_distributed.py at R-MAT 2^12 / 40,000, 4
             LocalMesh thread ranks, fused, one timed call a mode: every
             mode within 1e-5 of the single device's counts of the same
             colorings; (a) and (b) launch spmm_edgetile, color_combine and
             fused_count at least once; (c) examples/torch_train_lm.py on
             the reduced smollm-360m: 2 steps with a checkpoint, a resumed
             run and an uninterrupted one to step 4, losses and weights
             within 1e-6 relative.

Then it prints the card's name and power limit, one JSON object with a
``kernels`` list (each kernel's launches on the paths it runs, times
beside its plain version, a library call where one exists and its bound),
and as the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# shared memory of the H100: 132 SMs x 128 bytes a clock x 1.98 GHz (data
# sheet); an exact float32 combine FMA with both operands staged there reads
# 2.25 wavefronts of 128 bytes a warp (two operands, a quarter of a split
# entries' broadcast), 9 bytes a lane
SMEM_BYTES_PER_S = 132 * 128 * 1.98e9
SMEM_BYTES_PER_FMA = 2.25 * 128 / 32
MAIN_BATCH = 4  # colorings per call on the main path (unfused peak about 33 GB)
MAIN_CALLS = 2  # batches per mode on the main path
DENSE_BATCH = 16  # colorings per call on the dense cell (widest table 3.33 GB)
DENSE_ITERS = 32  # colorings per estimate on the dense cell: 2 calls
DENSE_PLAIN_BLOCKS = 8  # row blocks the dense-product plain block SpMM is held on
PLAIN_RTOL = 1e-5  # float32 order: index_add_ uses atomics, counts exceed 2^24
ORDER_WIDTH = 66  # node width of phase 2's order-sensitive checks (the sequential sum is slow)
LM_ARCH = "granite-3-8b"
LM_BATCH = 4  # prompts per prefill
LM_LEN = 4096  # tokens per prompt
LM_TIMED = 2  # timed prefills, after one warm one
LM_DECODE = 32  # greedy decode steps
LM_DECODE_TOL = 2e-2  # float32 decode vs forward logits (tests/test_models.py:114)
LM_BF16_RATIO = 1.5  # bf16 decode vs float32 forward, over bf16 forward vs float32 forward
LM_CARD_CPU_LEN = 256  # tokens of the 2-layer float32 card-vs-CPU prefill
LM_CARD_CPU_RTOL = 1e-4  # float32 on both sides, TF32 off: summation order only
FLASH_F32_TOL = 1e-5  # float32 kernel vs float32 plain version: summation order
FLASH_BF16_ATOL = 1e-6  # beyond one bf16 step, for the float32 order near zero
RG_FLASH = (2, 10, 1, 4096, 256)  # recurrentgemma-2b's local-attention prefill (B, Hq, Hkv, L, D)
RG_WINDOW = 2048  # its local window
FAMILY_K = 10  # phase 9: the rmat500-family row's largest template, u10-2
FAMILY_BATCH = 8  # colorings per call (widest table C(10, 5) = 252 columns, 8.5 GB)
FAMILY_CALLS = 2  # batches per mode
TW2_K = 6  # phase 10: the bench-tw2-mixed row's largest template, cycle6
TW2_GRAPH = (2 ** 13, 64_000)  # the row's 7.8 edges a vertex at the largest apex axis that fits
TW2_BATCH = 2  # colorings per call (widest bag table 2.73e9 elements, 10.9 GB)
TW2_CALLS = 2
#: phase 11: the compacted rows, each at 2^22 vertices (widest table C(10, 5)
#: = 252 columns, 8.46 GB at B = 2): rmat-sparse-u10-2 at its degree of 1,
#: bench-sparse at its 1.465 edges a vertex
SPARSE_GRAPHS = {"rmat-sparse-u10-2": (2 ** 22, 2_097_152), "bench-sparse": (2 ** 22, 6_144_000)}
SPARSE_BATCH = 2  # colorings per call
SPARSE_CALLS = 2  # batches per mode and program
#: phase 3's compacted plans: big enough that a capacity (a multiple of 128)
#: is below n_pad, small enough for brute force
EXACT_COMPACT_GRAPH = (512, 600)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b) -> float:
    """``max |a - b|`` over row chunks, so no full-size temporary is made."""
    return max(((x - y).abs().max().item() for x, y in zip(a.split(1 << 16), b.split(1 << 16))),
               default=0.0)


def bound_ms(w):
    """The least time the card could take for one launch's work
    (``repro_torch.kernels.work``): the larger of its bytes at the HBM rate
    and its operations at their peaks (``roofline.analysis.bound_s``, the
    data sheet's rates), and which of the two it is."""
    from repro_torch.roofline.analysis import bound_s

    t, by = bound_s(w)
    return t * 1e3, by


def hbm_ms(nbytes: float) -> float:
    """``nbytes`` at the HBM rate, ms: what a design moves, beside its bound."""
    from repro_torch.roofline.analysis import HBM_BYTES_PER_S

    return nbytes / HBM_BYTES_PER_S * 1e3


def rmat_graph(n: int, m: int, skew: int = 3):
    """``relabel_random(rmat(n, m, skew, seed=0), seed=1)``, timed."""
    from repro_torch.core.graphs import relabel_random, rmat

    t0 = time.perf_counter()
    g = relabel_random(rmat(n, m, skew=skew, seed=0), seed=1)
    log(f"graph: R-MAT V={g.n} E_dir={g.num_directed} max_degree={g.max_degree} "
        f"avg_degree={g.avg_degree:.1f} synthesized in {time.perf_counter() - t0:.1f}s")
    return g


def _counters():
    """Each kernel's launch count: its wrapper and the attribute that counts
    it.  One wrapper takes both flash kernels, counted by route."""
    from repro_torch.kernels import (color_combine, flash_attention, fused_count, spmm_block,
                                     spmm_edgetile)

    flash = flash_attention.flash_attention
    return {"spmm_edgetile": (spmm_edgetile.spmm_edge_tile, "launches"),
            "spmm_block": (spmm_block.spmm_block, "launches"),
            "color_combine": (color_combine.color_combine, "launches"),
            "fused_count": (fused_count.fused_count, "launches"),
            "flash_attention": (flash, "launches_wgmma"),
            "flash_attention_fp32": (flash, "launches_fp32")}


def reset_launches():
    for fn, attr in _counters().values():
        fn.launches = 0
        setattr(fn, attr, 0)


def read_launches():
    return {name: getattr(fn, attr) for name, (fn, attr) in _counters().items()}


def node_shapes(plan, program=None, kinds=("combine",)):
    """Distinct (A, Bw, S, J) of the program's internal nodes of ``kinds``
    (default: the plan's own program, its tree nodes), with multiplicity;
    widths are per coloring and, on bag nodes, per apex vertex ``x``."""
    program = program if program is not None else plan.chain
    shapes = {}
    for i, nd in program.internal_nodes():
        if nd.kind not in kinds:
            continue
        tbl = plan.combine[i]
        key = (tbl.a, tbl.w, tbl.s, tbl.j)
        if key not in shapes:
            shapes[key] = [0, plan.combine[i]]
        shapes[key][0] += 1
    return shapes


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


#: instructions each redesigned library's design rests on (cuobjdump -sass):
#: wgmma and TMA loads; the float32 flash kernel's cp.async ring and float32
#: FMAs; bulk asynchronous copies for the block kernel's staging (and
#: cp.async for tables whose rows are not 16-byte aligned); 128-bit gathers
#: for the edge kernel; for the combine and fused kernels, 128-bit staging
#: loads (and gathers), 128-bit shared-memory reads of the split entries
#: (four splits a broadcast) and cp.async for their prefetch
SASS_NEEDS = {"flash_attention_wgmma": ("HGMMA", "UTMALDG"),
              "flash_attention": ("LDGSTS", "FFMA"),
              "spmm_block": ("UBLKCP", "LDGSTS"),
              "spmm_edgetile": ("LDG.E.128",),
              "color_combine": ("LDG.E.128", "LDS.128", "LDGSTS"),
              "fused_count": ("LDG.E.128", "LDS.128", "LDGSTS")}


#: instructions a library must not hold: the float32 flash kernel's
#: products are float32 FMAs on the CUDA cores, never tensor-core ones (TF32
#: would break its 1e-5 gate)
SASS_BARS = {"flash_attention": ("HMMA", "HGMMA")}


def phase_build():
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    times = _build.build(verbose=True)
    log(f"phase 1 build: {', '.join(f'{k} {v:.1f}s' for k, v in times.items())} "
        f"(wall {time.perf_counter() - t0:.1f}s)")
    counts = {}
    for name in dict.fromkeys([*SASS_NEEDS, *SASS_BARS]):
        sass = _build.sass(name)
        if sass is None:
            raise AssertionError(f"the toolkit has no cuobjdump: the {name} library's SASS is unread")
        lines = sass.splitlines()
        counts[name] = {op: sum(op in line for line in lines)
                        for op in SASS_NEEDS.get(name, ()) + SASS_BARS.get(name, ())}
        if not all(counts[name][op] for op in SASS_NEEDS.get(name, ())):
            raise AssertionError(f"the {name} library's SASS lacks an instruction of its design: "
                                 f"{counts[name]}")
        if any(counts[name][op] for op in SASS_BARS.get(name, ())):
            raise AssertionError(f"the {name} library's SASS holds a tensor-core instruction: "
                                 f"{counts[name]}")
        log(f"phase 1: {name}'s SASS holds {counts[name]} (instructions)")
    return counts


def near_2_22(gen, n_pad: int, batch: int, width: int, n_valid: int):
    """Integers 2^22 .. 2^22 + 1023 as float32 (exact), 0 on the sentinel and
    pad rows: a row of degree above 4 sums past 2^24, where float32 rounds,
    so the result shows the order of the adds."""
    import torch

    t = (torch.randint(0, 1024, (n_pad, batch, width), generator=gen, device=gen.device)
         + 2.0 ** 22).float()
    t[n_valid:] = 0
    return t


def order_check(sp, n_valid: int, batch: int, width: int, gen, tbl=None):
    """On a table whose sums round: spmm_edgetile == the sequential float32
    sum in CSR order (the order csr_chunk_gather, and so fused_count, uses)
    and, on a block plan, spmm_block == spmm_edgetile, bitwise; with the
    split tables ``tbl`` of a node whose right child is ``width`` wide,
    fused_count == color_combine(spmm_edgetile), bitwise (left: integers
    0..3).  Also records whether the plain version (index_add_) happens to
    give the same bits."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.color_combine import color_combine
    from repro_torch.kernels.fused_count import fused_count
    from repro_torch.kernels.spmm_block import spmm_block
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    t = near_2_22(gen, sp.n_pad, batch, width, n_valid)
    t0 = time.perf_counter()
    seq = ref.spmm_csr_order_ref(sp.indptr, sp.indices, t)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    edges = spmm_edge_tile(sp.indptr, sp.indices, t)
    deg = torch.diff(sp.indptr)
    res = {"width": width, "batch": batch, "values": "2^22 + randint(0, 1024)",
           "rows_past_2_24": int((deg > 4).sum()),
           "edges_eq_csr_order": torch.equal(edges, seq),
           "index_add_eq_csr_order": torch.equal(ref.spmm_segment_ref(sp.indptr, sp.indices, t), seq)}
    if sp.kind == "blocks":
        res["blocks_eq_edges"] = torch.equal(spmm_block(sp, t), edges)
    if tbl is not None:
        del seq
        left = torch.randint(0, 4, (sp.n_pad, batch, tbl.a), generator=gen,
                             device=gen.device).float()
        unfused = color_combine(left, edges, tbl)
        res["fused_eq_unfused"] = torch.equal(fused_count(sp.indptr, sp.indices, left, t, tbl),
                                              unfused)
        del left, unfused
    del t, edges
    torch.cuda.empty_cache()
    if not (res["edges_eq_csr_order"] and res.get("blocks_eq_edges", True)
            and res.get("fused_eq_unfused", True)):
        raise AssertionError(f"summation order differs on sums past 2^24: {res}")
    log(f"phase 2 order (sequential sum {seq_s:.2f}s): {res}")
    return res


def hub_cut(sp, count: int = 10):
    """A copy of the CSR whose ``count`` largest rows have no edges: the edge
    kernel's time on it, beside its time on the whole CSR, is what the hub
    rows cost."""
    import torch

    deg = torch.diff(sp.indptr)
    keep = torch.ones_like(deg, dtype=torch.bool)
    keep[torch.topk(deg, count).indices] = False
    dst = torch.repeat_interleave(torch.arange(deg.numel(), device=deg.device), deg)
    ptr = torch.zeros_like(sp.indptr)
    ptr[1:] = torch.cumsum(torch.where(keep, deg, 0), 0)
    return ptr, sp.indices[keep[dst]].contiguous()


def csr_tensor(sp):
    """The plan's CSR as ``torch.sparse_csr_tensor`` (the library yardstick)."""
    import torch

    e = sp.num_directed
    return torch.sparse_csr_tensor(sp.indptr, sp.indices.long(),
                                   torch.ones(e, device=sp.indptr.device), (sp.n_pad, sp.n_pad))


def tree_shape_rows(sp, batch: int, shape_key, mult: int, tbl, gen, csr, rows, tag: str,
                    hub=None):
    """One tree-node shape ``(A, W, S, J)``: each of the edge SpMM, combine
    and fused kernels against its plain version (exact, on integer tables),
    timed beside the plain version, the library call where one exists and
    the bound; appended to ``rows``."""
    import torch
    from repro_torch.kernels import ref, work
    from repro_torch.kernels.color_combine import color_combine
    from repro_torch.kernels.fused_count import fused_count
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    a, bw, s, j = shape_key
    n_pad, e, dev = sp.n_pad, sp.num_directed, sp.indptr.device

    def table(width, hi):
        return torch.randint(0, hi, (n_pad, batch, width), generator=gen, device=dev).float()

    shape = f"A={a} B={bw} S={s} J={j} x{mult}"
    # Each check frees its outputs before the timings, so that at batch 4
    # and W = 792 (13 GB a table) no more than three tables are live.
    # The gather bound counts every edge's read of a B*W row segment once:
    # the bytes this design moves, beside the contract bound (each table
    # read once).
    gather_ms = hbm_ms(e * batch * bw * 4)
    # SpMM: sums of at most max_degree values <= 3 stay far below 2^24
    right = table(bw, 4)
    got = spmm_edge_tile(sp.indptr, sp.indices, right)
    want = ref.spmm_segment_ref(sp.indptr, sp.indices, right)
    err = max_abs_err(got, want)
    del want
    flat = right.reshape(n_pad, -1)
    lib_equal = torch.equal(torch.sparse.mm(csr, flat).reshape(got.shape), got)
    del got
    if err != 0 or not lib_equal:
        raise AssertionError(f"spmm_edgetile != plain at {shape}: max_abs_err {err}, "
                             f"library equal {lib_equal}")
    row = dict(
        shape=shape, mult=mult, err=err,
        ms=cuda_ms(lambda: spmm_edge_tile(sp.indptr, sp.indices, right)),
        plain_ms=cuda_ms(lambda: ref.spmm_segment_ref(sp.indptr, sp.indices, right), 1),
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, flat)),
        bound=bound_ms(work.spmm_edge(n_pad, n_pad, e, batch * bw)), gather_ms=gather_ms)
    if hub is not None:
        row["hub_cut_ms"] = cuda_ms(lambda: spmm_edge_tile(hub[0], hub[1], right))
    rows["spmm_edgetile"].append(row)
    del right, flat
    # combine: J * 3 * 3 <= 4455 per output
    left, m = table(a, 4), table(bw, 4)
    got = color_combine(left, m, tbl)
    want = ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2)
    err = max_abs_err(got, want)
    del got, want
    if err != 0:
        raise AssertionError(f"color_combine != plain at {shape}: max_abs_err {err}")
    # the staged floor: the bound, or the FMAs' shared-memory reads if longer
    smem_ms = n_pad * batch * s * j * SMEM_BYTES_PER_FMA / SMEM_BYTES_PER_S * 1e3
    bound = bound_ms(work.color_combine(n_pad * batch, a, bw, s, j, tbl.jp))
    rows["color_combine"].append(dict(
        shape=shape, mult=mult, err=err,
        ms=cuda_ms(lambda: color_combine(left, m, tbl)),
        plain_ms=cuda_ms(lambda: ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2), 1),
        library_ms=None, bound=bound, gather_ms=None, staged_floor_ms=max(bound[0], smem_ms)))
    del left, m
    # fused: 0/1 tables, so J * max_degree stays below 2^24
    left, right = table(a, 2), table(bw, 2)
    got = fused_count(sp.indptr, sp.indices, left, right, tbl)
    want = ref.fused_count_ref(sp.indptr, sp.indices, left, right, tbl.idx1, tbl.idx2)
    err = max_abs_err(got, want)
    del got, want
    if err != 0:
        raise AssertionError(f"fused_count != plain at {shape}: max_abs_err {err}")
    rows["fused_count"].append(dict(
        shape=shape, mult=mult, err=err,
        ms=cuda_ms(lambda: fused_count(sp.indptr, sp.indices, left, right, tbl)),
        plain_ms=cuda_ms(lambda: ref.fused_count_ref(
            sp.indptr, sp.indices, left, right, tbl.idx1, tbl.idx2), 1),
        library_ms=None,
        bound=bound_ms(work.fused_count(n_pad, n_pad, e, batch, a, bw, s, j, tbl.jp)),
        gather_ms=gather_ms, staged_floor_ms=max(gather_ms, smem_ms)))
    del left, right
    extra = (f"; ten largest rows cut {rows['spmm_edgetile'][-1]['hub_cut_ms']:.3f}ms"
             if hub is not None else "")
    log(f"{tag} {shape}: " + "  ".join(
        f"{k} {v[-1]['ms']:.3f}ms (plain {v[-1]['plain_ms']:.1f}, bound "
        f"{v[-1]['bound'][0]:.3f} {v[-1]['bound'][1]})" for k, v in rows.items() if v)
        + f"; spmm_edgetile library {rows['spmm_edgetile'][-1]['library_ms']:.3f}ms{extra}, "
        f"gather {gather_ms:.1f}ms")
    torch.cuda.empty_cache()


def phase_kernels(plan, batch: int):
    """Each kernel against its plain version at every node shape of ``plan``."""
    import torch

    dev = plan.device
    sp = plan.spmm_plan
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    csr = csr_tensor(sp)
    hub = hub_cut(sp)
    rows = {"spmm_edgetile": [], "color_combine": [], "fused_count": []}
    for key, (mult, tbl) in sorted(node_shapes(plan).items()):
        tree_shape_rows(sp, batch, key, mult, tbl, gen, csr, rows, "phase 2", hub=hub)
    del hub
    order_tbl = next(t for _, t in node_shapes(plan).values() if t.w == ORDER_WIDTH)
    order = order_check(sp, plan.n, batch, ORDER_WIDTH, gen, order_tbl)
    return rows, order


#: (k, t1, t2) of the widest nodes of the named templates: u14's
#: (364, 3003, 2002, 84), u15-2's (455, 6435, 3003, 120) and its root
#: (1365, 1365, 1, 1365)
WIDE_NODES = {"u14": (14, 3, 6), "u15-2": (15, 3, 7), "u15-2 root": (15, 4, 11)}


def phase_kernels_wide(dev, batch: int):
    """The combine and fused kernels at the widest nodes of u14 and u15-2 on
    a small R-MAT graph: each == its plain version (integer tables), fused
    == color_combine(spmm_edgetile) bitwise; logs the tile plan and times."""
    import torch
    from repro_torch.core.graphs import edge_list, rmat
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.color_combine import color_combine, device_smem_limits, plan_tile
    from repro_torch.kernels.fused_count import fused_count
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    g = rmat(2 ** 12, 40_000, skew=3, seed=3)
    sp = ops.build_spmm_plan(*edge_list(g), g.n, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(99)
    limits = device_smem_limits(dev)
    out = {}
    for name, (k, t1, t2) in WIDE_NODES.items():
        tbl = ops.build_combine_tables(k, t1, t2, device=dev)
        left = torch.randint(0, 2, (sp.n_pad, batch, tbl.a), generator=gen, device=dev).float()
        right = torch.randint(0, 2, (sp.n_pad, batch, tbl.w), generator=gen, device=dev).float()
        right[g.n:] = 0
        m = spmm_edge_tile(sp.indptr, sp.indices, right)
        got = color_combine(left, m, tbl)
        want = ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2)
        fused = fused_count(sp.indptr, sp.indices, left, right, tbl)
        res = dict(combine_err=max_abs_err(got, want),
                   fused_err=max_abs_err(fused, ref.fused_count_ref(
                       sp.indptr, sp.indices, left, right, tbl.idx1, tbl.idx2)),
                   fused_eq_unfused=torch.equal(fused, got),
                   combine_tile=dataclasses.astuple(plan_tile(tbl.a, tbl.w, tbl.s, tbl.jp,
                                                              limits))[:3],
                   fused_tile=dataclasses.astuple(plan_tile(tbl.a, tbl.w, tbl.s, tbl.jp,
                                                            limits, batch=batch))[:3],
                   combine_ms=cuda_ms(lambda: color_combine(left, m, tbl)),
                   fused_ms=cuda_ms(lambda: fused_count(sp.indptr, sp.indices, left, right, tbl)))
        shape = f"A={tbl.a} B={tbl.w} S={tbl.s} J={tbl.j}"
        if res["combine_err"] or res["fused_err"] or not res["fused_eq_unfused"]:
            raise AssertionError(f"{name} {shape}: {res}")
        log(f"phase 2 wide {name} {shape} (batch {batch}, V={g.n}): == plain, fused == unfused; "
            f"{res}")
        out[name] = res
        del left, right, m, got, want, fused
    torch.cuda.empty_cache()
    return out


def row_block_sample(sp, count: int):
    """A block plan of the graph's edges into ``count`` row blocks spread
    over the graph (first and last included), built as any plan is: its
    other row blocks keep no patch.  Returns it and the sampled rows."""
    import torch
    from repro_torch.kernels import ops

    nrb = sp.patch_ptr.numel() - 1
    dev = sp.indptr.device
    keep = torch.linspace(0, nrb - 1, count, device=dev).round().long().unique()
    deg = torch.diff(sp.indptr)
    dst = torch.repeat_interleave(torch.arange(deg.numel(), device=dev), deg)
    sel = torch.zeros(nrb, dtype=torch.bool, device=dev)
    sel[keep] = True
    edge = sel[dst // 128]
    sub = ops.build_spmm_plan(dst[edge].cpu().numpy(), sp.indices[edge].cpu().numpy(), sp.n,
                              kind="blocks", device=dev)
    rows = (keep[:, None] * 128 + torch.arange(128, device=dev)).reshape(-1)
    return sub, rows, len(keep)


def used_source_rows(sp) -> int:
    """Source rows the block kernel stages, summed over patches: the
    popcount of each patch's column union."""
    from repro_torch.kernels import ops

    return int(ops.popcount32(sp.patch_union.cpu().numpy()).sum())


def phase_kernels_dense(plan, batch: int):
    """The block SpMM at every u12-2 node width on the dense cell, on the
    whole graph: == the plain edge-list neighbor sum (``index_add_``) of the
    same function and == spmm_edgetile; on a sample of row blocks also ==
    its own dense-patch plain version, which does 146x the useful adds and
    cannot run whole.  Timed beside the edge kernel, the whole-graph plain
    version, the library call and the bound."""
    import torch
    from repro_torch.kernels import ref, work
    from repro_torch.kernels.spmm_block import spmm_block
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    dev = plan.device
    sp = plan.spmm_plan
    n_pad, e, nb = sp.n_pad, sp.num_directed, sp.num_patches
    nrb = n_pad // 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    sub, sub_rows, n_sub = row_block_sample(sp, DENSE_PLAIN_BLOCKS)
    sub_bits = sub.patch_bits.to(dev)  # the plan keeps its bitmasks on the host
    used = used_source_rows(sp)
    log(f"phase 2 dense: {nb} patches, {e / nb:.1f} edges/patch, staged source rows "
        f"{used} ({used / (nb * 128):.3f} of 128 per patch, at most {sp.patch_max_used}); "
        f"slot lists {sp.patch_slots.numel()} bytes (at most {sp.patch_max_slots} a patch)")
    csr = torch.sparse_csr_tensor(sp.indptr, sp.indices.long(), torch.ones(e, device=dev),
                                  (n_pad, n_pad))
    rows = []
    widths = {}
    for i, nd in plan.chain.internal_nodes():
        widths[plan.widths[nd.right]] = widths.get(plan.widths[nd.right], 0) + 1
    for w, mult in sorted(widths.items()):
        shape = f"B={batch} W={w} x{mult}"
        bw = batch * w
        table = torch.randint(0, 4, (n_pad, batch, w), generator=gen, device=dev).float()
        table[plan.n:] = 0
        got = spmm_block(sp, table)
        edges_equal = torch.equal(got, spmm_edge_tile(sp.indptr, sp.indices, table))
        err = max_abs_err(got, ref.spmm_segment_ref(sp.indptr, sp.indices, table))
        plain = ref.spmm_block_ref(sub.patch_ptr, sub.patch_col, sub_bits, table)
        on_sub = spmm_block(sub, table)
        sub_err = max(max_abs_err(on_sub, plain), max_abs_err(got[sub_rows], plain[sub_rows]))
        del got, on_sub, plain
        if err != 0 or sub_err != 0 or not edges_equal:
            raise AssertionError(f"spmm_block at {shape}: max_abs_err vs the whole-graph plain "
                                 f"version {err}, vs the dense-patch one on {n_sub} row blocks "
                                 f"{sub_err}; == spmm_edgetile {edges_equal}")
        flat = table.reshape(n_pad, -1)
        row = dict(
            shape=shape, mult=mult, err=err,
            ms=cuda_ms(lambda: spmm_block(sp, table)),
            edgetile_ms=cuda_ms(lambda: spmm_edge_tile(sp.indptr, sp.indices, table)),
            library_ms=cuda_ms(lambda: torch.sparse.mm(csr, flat)),
            plain_ms=cuda_ms(lambda: ref.spmm_segment_ref(sp.indptr, sp.indices, table), 1),
            block_ref_ms=cuda_ms(lambda: ref.spmm_block_ref(sub.patch_ptr, sub.patch_col,
                                                            sub_bits, table), 1),
            sample_ms=cuda_ms(lambda: spmm_block(sub, table)),
            bound=bound_ms(work.spmm_block(n_pad, nb, e, bw)),
            staging_ms=hbm_ms(used * bw * 4), gather_ms=hbm_ms(e * bw * 4))
        rows.append(row)
        del table, flat
        torch.cuda.empty_cache()
        log(f"phase 2 dense {shape}: spmm_block {row['ms']:.3f}ms  spmm_edgetile "
            f"{row['edgetile_ms']:.3f}ms  plain {row['plain_ms']:.1f}ms  library "
            f"{row['library_ms']:.3f}ms  bound {row['bound'][0]:.3f} {row['bound'][1]} (staging "
            f"{row['staging_ms']:.1f}, gather {row['gather_ms']:.1f}); on {n_sub} of {nrb} row "
            f"blocks: dense-patch plain {row['block_ref_ms']:.1f}ms, kernel "
            f"{row['sample_ms']:.3f}ms")
    order = order_check(sp, plan.n, batch, ORDER_WIDTH, gen)
    return rows, order


#: the treewidth-2 registry rows phase 3 holds == brute force
EXACT_NONTREE = ("cycle3", "cycle4", "cycle5", "cycle6", "diamond", "bowtie", "house")


def phase_exact(device):
    import numpy as np
    from repro_torch.core.brute_force import count_colorful_maps
    from repro_torch.core.count_engine import build_counting_plan, colorful_map_count
    from repro_torch.core.graphs import erdos_renyi, rmat
    from repro_torch.core.templates import template

    checked = 0
    for g in (erdos_renyi(40, 4.0, seed=2), rmat(64, 300, skew=3, seed=5)):
        for name in ("u3-1", "u5-2", "u7-2") + EXACT_NONTREE:
            tree = template(name)
            coloring = np.random.default_rng(checked).integers(0, tree.n, g.n).astype(np.int32)
            want = count_colorful_maps(g, tree, coloring)
            for kind in ("edges", "blocks"):
                for fuse in (False, True):
                    plan = build_counting_plan(g, tree, spmm_kind=kind, fuse=fuse, device=device)
                    got = float(colorful_map_count(plan, coloring))
                    if got != want:
                        raise AssertionError(f"{g.name} {name} {kind} fuse={fuse}: {got} != "
                                             f"brute force {want}")
            checked += 1
            log(f"phase 3 {g.name} {name}: {want} colorful maps; edges and blocks, fused and "
                f"unfused == brute force")
    phase_exact_compact(device)


@contextlib.contextmanager
def floors_forced_down():
    """The compaction profitability floors at 1 (as the reference's tests
    force them), so that every sparse enough node of a small template
    engages; restored after."""
    from repro_torch.core import frontier

    saved = frontier.MIN_COMBINE_ELEMENTS, frontier.MIN_TABLE_WIDTH
    frontier.MIN_COMBINE_ELEMENTS = frontier.MIN_TABLE_WIDTH = 1
    try:
        yield
    finally:
        frontier.MIN_COMBINE_ELEMENTS, frontier.MIN_TABLE_WIDTH = saved


def phase_exact_compact(device):
    """Phase 3 on compacted plans (density_threshold 1.0, floors forced
    down): edge and block plans, fused and unfused, through the checked
    program and count_fn's fallback wrapper == brute force."""
    import numpy as np
    from repro_torch.core.brute_force import count_colorful_maps
    from repro_torch.core.count_engine import build_counting_plan, colorful_map_count_checked
    from repro_torch.core.graphs import rmat
    from repro_torch.core.templates import template

    g = rmat(*EXACT_COMPACT_GRAPH, skew=3, seed=5)
    for name in ("u3-1", "u5-2", "u7-2"):
        tree = template(name)
        coloring = np.random.default_rng(11).integers(0, tree.n, g.n).astype(np.int32)
        want = count_colorful_maps(g, tree, coloring)
        caps = {}
        for kind in ("edges", "blocks"):
            for fuse in (False, True):
                with floors_forced_down():
                    plan = build_counting_plan(g, tree, spmm_kind=kind, fuse=fuse, device=device,
                                               compact=True, density_threshold=1.0)
                spec = plan.compaction
                # u7-2 is the one whose right children are internal (table caps)
                if (not spec.combine_caps or (kind == "blocks" and spec.table_caps)
                        or (name == "u7-2" and kind == "edges" and not spec.table_caps)):
                    raise AssertionError(f"compact {name} {kind}: caps {spec}")
                maps, ok = colorful_map_count_checked(plan, coloring)
                if not bool(ok) or float(maps) != want:
                    raise AssertionError(f"compact {name} {kind} fuse={fuse}: {float(maps)} "
                                         f"(ok {bool(ok)}) != brute force {want}")
                caps[kind] = (dict(spec.table_caps), dict(spec.combine_caps))
        log(f"phase 3 compact {g.name} {name}: {want} colorful maps; caps (table, combine) "
            f"{caps}; edges and blocks, fused and unfused == brute force")


def plain_counts(plan, program, colorings) -> tuple:
    """Colorful maps of ``colorings`` through the plain versions on the card
    (the edge-list neighbor sum, ``index_add_``, for either plan kind), one
    ``[B]`` per root of ``program``; bag nodes run the engine's own leaf,
    collapse and filter with the plain combine on the same views."""
    from repro_torch.core import count_engine
    from repro_torch.core.table_program import leaf_table, root_count, run_table_program
    from repro_torch.core.templates import program_has_bags
    from repro_torch.kernels import ref

    sp = plan.spmm_plan

    def plain_combine(left, m, tbl):
        return ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2)

    def plain_node(i, tbl, c_left, c_right, f_left, f_right):
        m = ref.spmm_segment_ref(sp.indptr, sp.indices, c_right)
        if program.nodes[i].kind == "bag_combine":
            rows, b = c_left.shape[:2]
            out = plain_combine(c_left.view(rows, b * plan.n, -1), m.view(rows, b * plan.n, -1), tbl)
            return out.view(rows, b, -1)
        return plain_combine(c_left, m, tbl)

    leaf = leaf_table(colorings, plan.k, plan.n)
    bag = None
    if program_has_bags(program):
        bag = count_engine._bag_fns(plan, program, colorings, leaf)._replace(
            join_fn=lambda i, tbl, left, right: plain_combine(left, right, tbl))
    return run_table_program(program, plan.combine, leaf, plan.n, plain_node,
                             root_fn=root_count, bag=bag)


def plain_maps(plan, colorings) -> float:
    """Colorful maps of one coloring of a single-template plan through the
    plain versions on the card."""
    (maps,) = plain_counts(plan, plan.chain, colorings)
    return maps.item()


def phase_main(plan, batch: int, calls: int):
    """The main path at full width; returns the kernels' launch counts."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.count_engine import colorful_map_count, count_fn, draw_colorings
    from repro_torch.core.estimator import call_key

    dev = plan.device
    key = prng.key(0)
    n_internal = len(plan.chain.internal_nodes())
    results = {}
    # drawing colorings launches threefry's integer kernels, loaded at first
    # use: warm them outside the timer and time one draw of the batch; the
    # card's draw must equal the CPU's, which the CPU tests hold == jax.random
    draw_ms = cuda_ms(lambda: draw_colorings(plan, batch, key))
    on_cpu = prng.randint(key, (batch, plan.n_pad), 0, plan.k, device="cpu")
    if not torch.equal(draw_colorings(plan, batch, key).cpu(), on_cpu):
        raise AssertionError("colorings drawn on the card differ from the CPU's")
    log(f"phase 4: drawing {batch} colorings of {plan.n_pad} vertices takes {draw_ms:.3f} ms; "
        f"== the CPU's draw")
    reset_launches()
    for fuse in (False, True):
        p = dataclasses.replace(plan, fuse=fuse)
        f = count_fn(p, batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        maps = []
        t0 = time.perf_counter()
        for c in range(calls):
            m, est = f(call_key(key, c))
            maps.append(m)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        maps = torch.cat(maps)
        if not torch.isfinite(maps).all() or maps.shape != (batch * calls,):
            raise AssertionError(f"fuse={fuse}: bad maps {maps}")
        peak = torch.cuda.max_memory_allocated(dev)
        results[fuse] = (maps, dt, peak)
        log(f"phase 4 fuse={fuse}: {batch * calls} colorings in {dt:.2f}s "
            f"({dt / (batch * calls) * 1e3:.1f} ms/coloring), peak "
            f"{peak / 2 ** 30:.2f} GiB, maps {maps.tolist()}")
    launches = read_launches()
    want = n_internal * calls
    if launches != {"spmm_edgetile": want, "spmm_block": 0, "color_combine": want,
                    "fused_count": want, "flash_attention": 0, "flash_attention_fp32": 0}:
        raise AssertionError(f"launch counts {launches}, plan predicts {want} each")
    # the unfused DP alone, on colorings drawn before the timer: what the
    # draw adds to the end-to-end time
    drawn = [draw_colorings(plan, batch, call_key(key, c)) for c in range(calls)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = torch.cat([colorful_map_count(plan, cols) for cols in drawn])
    torch.cuda.synchronize()
    predrawn_ms = (time.perf_counter() - t0) / (batch * calls) * 1e3
    if not torch.equal(again, results[False][0]):
        raise AssertionError("the DP on pre-drawn colorings gave other maps")
    log(f"phase 4 fuse=False, colorings drawn before the timer: {predrawn_ms:.1f} ms/coloring")
    if not torch.equal(results[False][0], results[True][0]):
        raise AssertionError("fused and unfused maps differ")
    if not results[True][2] < results[False][2]:
        raise AssertionError(f"fused peak {results[True][2]} not below unfused {results[False][2]}")
    # coloring 0 of call 0 through the plain versions on the card
    got = results[False][0][0].item()
    plain = plain_maps(plan, draw_colorings(plan, batch, call_key(key, 0))[:1])
    if not math.isclose(plain, got, rel_tol=PLAIN_RTOL):
        raise AssertionError(f"kernels {got} vs plain versions {plain} beyond rtol {PLAIN_RTOL}")
    log(f"phase 4: fused == unfused bitwise over {batch * calls} colorings; launches {launches}; "
        f"plain versions {plain!r} vs kernels {got!r} "
        f"(rel {abs(plain - got) / max(abs(got), 1):.2e}); "
        f"est/coloring {got * plan.scale:.6g}")
    per = {f: (dt / (batch * calls) * 1e3, peak) for f, (_, dt, peak) in results.items()}
    return launches, per, (draw_ms, predrawn_ms)


def phase_dense(g, dev):
    """Counter.estimate on the dense cell with spmm_kind="auto" (the block
    plan), then "edges"; one plan lives at a time, so the peaks compare."""
    import numpy as np
    import torch
    from repro_torch.api import Counter
    from repro_torch.core import prng
    from repro_torch.core.count_engine import draw_colorings
    from repro_torch.core.estimator import call_key

    key = prng.key(0)
    runs = {}
    for kind, want_kind, spmm in (("auto", "blocks", "spmm_block"),
                                  ("edges", "edges", "spmm_edgetile")):
        counter = Counter.from_graph(g, "u12-2", backend="single", spmm_kind=kind, device=dev)
        t0 = time.perf_counter()
        plan = counter.plan
        log(f"phase 5 spmm_kind={kind}: plan kind={plan.spmm_plan.kind} (density "
            f"{plan.spmm_plan.patch_density}) in {time.perf_counter() - t0:.1f}s")
        if plan.spmm_plan.kind != want_kind:
            raise AssertionError(f"spmm_kind={kind} planned {plan.spmm_plan.kind}")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launches()
        t0 = time.perf_counter()
        res = counter.estimate(n_iter=DENSE_ITERS, batch=DENSE_BATCH, key=key)
        dt = time.perf_counter() - t0  # the estimator copied every result to the host
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated(dev)
        want = len(plan.chain.internal_nodes()) * -(-DENSE_ITERS // DENSE_BATCH)
        expect = {"spmm_edgetile": 0, "spmm_block": 0, "color_combine": want, "fused_count": 0,
                  "flash_attention": 0, "flash_attention_fp32": 0}
        expect[spmm] = want
        if launches != expect:
            raise AssertionError(f"spmm_kind={kind}: launch counts {launches}, plan predicts {expect}")
        if res.samples.shape != (DENSE_ITERS,) or not np.isfinite(res.samples).all():
            raise AssertionError(f"spmm_kind={kind}: bad samples {res.samples}")
        runs[kind] = dict(res=res, ms=dt / DENSE_ITERS * 1e3, peak=peak, launches=launches)
        log(f"phase 5 spmm_kind={kind}: {DENSE_ITERS} colorings in {dt:.2f}s "
            f"({dt / DENSE_ITERS * 1e3:.1f} ms/coloring), peak {peak / 2 ** 30:.2f} GiB, "
            f"estimate {res.estimate:.6g} RSD {res.relative_sd:.3f}; launches {launches}")
        if kind == "edges":  # the plain pass needs only the CSR, which both plans carry
            colorings = draw_colorings(plan, DENSE_BATCH, call_key(key, 0))[:1]
            plain, scale = plain_maps(plan, colorings), plan.scale
        del counter, plan
        torch.cuda.empty_cache()
    a, b = runs["auto"]["res"], runs["edges"]["res"]
    if not np.array_equal(a.samples, b.samples):
        raise AssertionError(f"block and edge samples differ: {a.samples} vs {b.samples}")
    got = float(a.samples[0] / scale)
    if not math.isclose(plain, got, rel_tol=PLAIN_RTOL):
        raise AssertionError(f"kernels {got} vs plain versions {plain} beyond rtol {PLAIN_RTOL}")
    log(f"phase 5: blocks == edges bitwise over {DENSE_ITERS} samples; plain versions "
        f"{plain!r} vs kernels {got!r} (rel {abs(plain - got) / max(abs(got), 1):.2e})")
    return {kind: dict(ms_per_coloring=r["ms"], peak_bytes=r["peak"], launches=r["launches"])
            for kind, r in runs.items()}


def _launch(argv):
    from repro_torch.launch.count import main as count_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        count_main(argv)
    out = buf.getvalue()
    log("".join(f"  {line}\n" for line in out.splitlines()).rstrip())
    return out.splitlines()


def _estimates(lines):
    return [ln for ln in lines if ln.startswith("estimate")]


def phase_launch():
    from repro_torch.core.graphs import rmat, save_npz

    base = ["--config", "bench-small", "--mode", "single", "--iters", "8", "--batch", "4"]
    plain, fused = _launch(base), _launch(base + ["--fuse"])
    if not _estimates(plain) or _estimates(plain) != _estimates(fused):
        raise AssertionError(f"launcher estimates differ: {plain} vs {fused}")
    log("phase 6: launcher estimates identical with and without --fuse")
    with tempfile.TemporaryDirectory(prefix=".smoke_tmp", dir=ROOT) as tmp:
        ckpt = str(Path(tmp) / "ckpt")
        first = _launch(base + ["--checkpoint-dir", ckpt])
        again = _launch(base + ["--resume", ckpt])
        if _estimates(first) != _estimates(plain) or _estimates(again) != _estimates(plain):
            raise AssertionError(f"checkpointed or resumed estimates differ: {first} / {again}")
        if "resumed: 8 colorings restored from checkpoint (progress/RSD include them)" not in again:
            raise AssertionError(f"--resume restored nothing: {again}")
        log("phase 6: --checkpoint-dir then --resume print the same estimate")
        path = str(Path(tmp) / "dense.npz")
        save_npz(rmat(2 ** 12, 500_000, skew=3, seed=0), path)
        dense = ["--graph", path] + base
        fused = _launch(dense + ["--fuse", "--spmm-kind", "auto"])
        blocks = _launch(dense + ["--spmm-kind", "auto"])
    if not any(ln.startswith("mode=single(batch=4,fuse=True,spmm=edges)") for ln in fused):
        raise AssertionError(f"--fuse --spmm-kind auto did not fuse over edges: {fused}")
    if "kind=blocks" not in " ".join(blocks) or _estimates(blocks) != _estimates(fused):
        raise AssertionError(f"unfused auto on the dense file: {blocks}")
    log("phase 6: --fuse --spmm-kind auto on a dense graph runs fused over edges "
        "(unfused auto picks blocks; same estimates)")
    base = ["--config", "bench-sparse", "--iters", "8", "--batch", "4"]
    comp, dense = _launch(base), _launch(base + ["--density-threshold", "-1"])
    if (not _estimates(comp) or _estimates(comp) != _estimates(dense)
            or not any(ln.startswith("compaction caps: {'combine[") for ln in comp)
            or "compaction caps: none engaged" not in dense):
        raise AssertionError(f"bench-sparse: {comp} vs --density-threshold -1 {dense}")
    log("phase 6: --config bench-sparse reports engaged caps and prints the estimates of "
        "--density-threshold -1")
    phase_launch_families()


def _template_lines(lines, name):
    return [ln for ln in lines if ln.strip().startswith(f"{name}:")]


def phase_launch_families():
    """The launcher's family path: ``--config bench-family`` prints a u5-2
    line equal to a run of u5-2 with the same key and k (the family u5-2,
    u7-2, k = 7) and to ``Counter.estimate`` of u5-2 with ``n_colors=7``;
    the treewidth-2 rows run, fused and unfused alike."""
    import torch
    from repro_torch.api import Counter
    from repro_torch.configs.subgraph import COUNTING_CONFIGS
    from repro_torch.core import prng

    base = ["--config", "bench-family", "--iters", "8", "--batch", "4"]
    full, pair = _launch(base), _launch(base + ["--templates", "u5-2,u7-2"])
    one = Counter.from_graph(COUNTING_CONFIGS["bench-family"].synthesize(), "u5-2",
                             n_colors=7, device=torch.device("cuda", 0)).estimate(
        n_iter=8, batch=4, key=prng.key(0))
    line = _template_lines(full, "u5-2")
    if (len(line) != 1 or line != _template_lines(pair, "u5-2")
            or f"median-of-means {one.estimate:.6g} " not in line[0]):
        raise AssertionError(f"bench-family's u5-2 line {line} vs the u5-2,u7-2 family "
                             f"{_template_lines(pair, 'u5-2')} and Counter.estimate "
                             f"{one.estimate:.6g}")
    log("phase 6: --config bench-family's u5-2 line == --templates u5-2,u7-2's == "
        "Counter.estimate(n_colors=7)")
    for config in ("bench-cycles", "bench-tw2-mixed"):
        names = COUNTING_CONFIGS[config].templates
        args = ["--config", config, "--iters", "8", "--batch", "4"]
        plain, fused = _launch(args), _launch(args + ["--fuse"])
        got = [ln for ln in plain if "median-of-means" in ln]
        if len(got) != len(names) or got != [ln for ln in fused if "median-of-means" in ln]:
            raise AssertionError(f"--config {config}: {plain} vs --fuse {fused}")
        log(f"phase 6: --config {config} runs its family of {len(names)}; --fuse prints the "
            f"same estimates")


def chunked_err(got, want_fn, rows: int, chunk: int) -> float:
    """``max |got[r0:r1] - want_fn(r0, r1)|`` over row chunks: the plain
    version is computed a chunk at a time, so no second full-size table is
    made."""
    err = 0.0
    for r0 in range(0, rows, chunk):
        r1 = min(r0 + chunk, rows)
        err = max(err, (got[r0:r1] - want_fn(r0, r1)).abs().max().item())
    return err


def bag_shape_rows(sp, batch: int, x: int, shape_key, mult: int, tbl, gen, csr, rows, tag: str):
    """One ``bag_combine`` shape ``(A, W, S, J)`` at ``x`` apex vertices: the
    edge SpMM on the ``[n_pad, B, x W]`` bag table and the combine on the
    ``[n_pad, B x, W]`` views, each against its plain version (exact, on
    integer tables; the plain version a block of rows at a time), timed
    beside the plain version on the whole table, the library call where one
    exists and the bound; appended to ``rows``."""
    import torch
    from repro_torch.kernels import ref, work
    from repro_torch.kernels.color_combine import color_combine
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    a, w, s, j = shape_key
    n_pad, e, dev = sp.n_pad, sp.num_directed, sp.indptr.device

    def table(width, hi):
        return torch.randint(0, hi, (n_pad, batch, x * width), generator=gen, device=dev).float()

    shape = f"bag A={a} B={w} S={s} J={j} x={x} x{mult}"
    right = table(w, 4)
    got = spmm_edge_tile(sp.indptr, sp.indices, right)
    err = chunked_err(got, lambda r0, r1: ref.spmm_segment_ref(sp.indptr[r0:r1 + 1], sp.indices,
                                                                right), n_pad, 512)
    del got
    if err != 0:
        raise AssertionError(f"spmm_edgetile != plain at {shape}: max_abs_err {err}")
    flat = right.view(n_pad, -1)
    bw = batch * x * w
    rows["spmm_edgetile"].append(dict(
        shape=shape, mult=mult, err=err,
        ms=cuda_ms(lambda: spmm_edge_tile(sp.indptr, sp.indices, right), 2),
        plain_ms=cuda_ms(lambda: ref.spmm_segment_ref(sp.indptr, sp.indices, right), 1),
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, flat), 2),
        bound=bound_ms(work.spmm_edge(n_pad, n_pad, e, bw)), gather_ms=hbm_ms(e * bw * 4)))
    del right, flat
    torch.cuda.empty_cache()
    left, m = table(a, 4), table(w, 4)
    lv, mv = left.view(n_pad, batch * x, a), m.view(n_pad, batch * x, w)
    got = color_combine(lv, mv, tbl)
    flat_l, flat_m, flat_g = left.view(-1, a), m.view(-1, w), got.view(-1, s)
    err = chunked_err(flat_g, lambda r0, r1: ref.color_combine_ref(
        flat_l[r0:r1], flat_m[r0:r1], tbl.idx1, tbl.idx2), flat_g.shape[0], 1 << 22)
    del got, flat_g
    if err != 0:
        raise AssertionError(f"color_combine != plain at {shape}: max_abs_err {err}")
    n_rows = n_pad * batch * x
    bound = bound_ms(work.color_combine(n_rows, a, w, s, j, tbl.jp))
    smem_ms = n_rows * s * j * SMEM_BYTES_PER_FMA / SMEM_BYTES_PER_S * 1e3
    rows["color_combine"].append(dict(
        shape=shape, mult=mult, err=err,
        ms=cuda_ms(lambda: color_combine(lv, mv, tbl), 2),
        plain_ms=cuda_ms(lambda: ref.color_combine_ref(lv, mv, tbl.idx1, tbl.idx2), 1),
        library_ms=None, bound=bound, gather_ms=None, staged_floor_ms=max(bound[0], smem_ms)))
    del left, m, lv, mv, flat_l, flat_m
    torch.cuda.empty_cache()
    log(f"{tag} {shape}: " + "  ".join(
        f"{k} {v[-1]['ms']:.3f}ms (plain {v[-1]['plain_ms']:.1f}, bound "
        f"{v[-1]['bound'][0]:.3f} {v[-1]['bound'][1]})"
        for k, v in rows.items() if k != "fused_count")
        + f"; spmm_edgetile library {rows['spmm_edgetile'][-1]['library_ms']:.3f}ms")


def dag_launches(program, calls: int) -> dict:
    """Launches the DAG predicts for ``calls`` unfused then ``calls`` fused
    passes: a combine or bag_combine node one SpMM and one combine, or (a
    tree node, fused) one fused launch; a bag_join one combine; a
    bag_collapse none."""
    kinds = [nd.kind for nd in program.nodes]
    tree, bag, join = kinds.count("combine"), kinds.count("bag_combine"), kinds.count("bag_join")
    return {"spmm_edgetile": calls * (tree + 2 * bag), "spmm_block": 0,
            "color_combine": calls * (tree + 2 * (bag + join)), "fused_count": calls * tree,
            "flash_attention": 0, "flash_attention_fp32": 0}


def dag_kernel_rows(plan, batch: int, tag: str):
    """Each kernel against its plain version at every node shape of the
    family plan's DAG: tree nodes as phase 2 holds them, bag_combine nodes on
    their bag tables and views.  The rows' DAGs have no bag_join (the
    bowtie's), whose combine tests/test_torch_gpu.py holds on the card."""
    import torch

    sp, dag, dev = plan.spmm_plan, plan.dag, plan.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(77)
    csr = csr_tensor(sp)
    rows = {"spmm_edgetile": [], "color_combine": [], "fused_count": []}
    for key, (mult, tbl) in sorted(node_shapes(plan, dag).items()):
        tree_shape_rows(sp, batch, key, mult, tbl, gen, csr, rows, tag)
    if node_shapes(plan, dag, ("bag_join",)):
        raise AssertionError(f"{tag}: a bag_join node, which this phase does not hold")
    for key, (mult, tbl) in sorted(node_shapes(plan, dag, ("bag_combine",)).items()):
        bag_shape_rows(sp, batch, plan.n, key, mult, tbl, gen, csr, rows, tag)
    return rows


def pass_totals(rows) -> dict:
    """A DAG pass's ms per kernel: each shape's time by its multiplicity."""
    return {name: {k: sum(r[k] * r["mult"] for r in shapes) for k in ("ms", "plain_ms")}
            | {"bound_ms": sum(r["bound"][0] * r["mult"] for r in shapes),
               "library_ms": (sum(r["library_ms"] * r["mult"] for r in shapes)
                              if shapes and shapes[0]["library_ms"] is not None else None),
               "max_abs_err": max((r["err"] for r in shapes), default=0.0)}
            for name, shapes in rows.items() if shapes}


def phase_dag(tag: str, g, plan, batch: int, calls: int):
    """A family's path at full width: count_fn_many unfused and fused,
    ``calls`` batches each from one key; maps of the two bitwise equal,
    launch counts as the DAG predicts, each template's own plan with
    ``n_colors=k`` on the same colorings, one coloring through the plain
    versions on the card within PLAIN_RTOL.  Returns the path's launches and
    what the kernels line reports."""
    import torch
    from repro_torch.core import prng
    from repro_torch.core.count_engine import (build_counting_plan, colorful_map_count,
                                               colorful_map_count_many, count_fn, count_fn_many,
                                               draw_colorings)
    from repro_torch.core.estimator import call_key
    from repro_torch.core.templates import template_program

    dev, dag = plan.device, plan.dag
    key = prng.key(0)
    names = [t.name for t in plan.templates]
    results = {}
    reset_launches()
    for fuse in (False, True):
        f = count_fn_many(dataclasses.replace(plan, fuse=fuse), batch)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        maps = torch.cat([f(call_key(key, c))[0] for c in range(calls)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev)
        if maps.shape != (batch * calls, len(names)) or not torch.isfinite(maps).all():
            raise AssertionError(f"{tag} fuse={fuse}: bad maps {maps}")
        results[fuse] = (maps, dt, peak)
        log(f"{tag} fuse={fuse}: {batch * calls} colorings in {dt:.2f}s "
            f"({dt / (batch * calls) * 1e3:.1f} ms/coloring), peak {peak / 2 ** 30:.2f} GiB "
            f"({peak} bytes), maps of coloring 0 {dict(zip(names, maps[0].tolist()))}")
    launches = read_launches()
    want = dag_launches(dag, calls)
    if launches != want:
        raise AssertionError(f"{tag}: launch counts {launches}, the DAG predicts {want}")
    if not torch.equal(results[False][0], results[True][0]):
        raise AssertionError(f"{tag}: fused and unfused maps differ")
    # the DP alone, on colorings drawn before the timer and with the
    # allocator warm from the runs above: what the draw and the first
    # batches' allocations add to the end-to-end time
    drawn = [draw_colorings(plan, batch, call_key(key, c)) for c in range(calls)]
    predrawn = {}
    for fuse in (False, True):
        p = dataclasses.replace(plan, fuse=fuse)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = torch.cat([colorful_map_count_many(p, cols) for cols in drawn])
        torch.cuda.synchronize()
        predrawn[fuse] = (time.perf_counter() - t0) / (batch * calls)
        if not torch.equal(again, results[False][0]):
            raise AssertionError(f"{tag} fuse={fuse}: the DP on pre-drawn colorings gave other maps")
    log(f"{tag}, colorings drawn before the timer: unfused {predrawn[False] * 1e3:.1f}, fused "
        f"{predrawn[True] * 1e3:.1f} ms/coloring")
    # each template's own plan, n_colors = k, on call 0's colorings; timed
    # on its second pass, beside the family's pre-drawn pass
    fam = results[False][0][:batch]
    singles, single_s, bitwise, worst = {}, 0.0, True, 0.0
    for r, t in enumerate(plan.templates):
        sp = build_counting_plan(g, t, n_colors=plan.k, device=dev)
        if not torch.equal(count_fn(sp, batch)(call_key(key, 0))[0], colorful_map_count(sp, drawn[0])):
            raise AssertionError(f"{tag} {t.name}: count_fn and the pre-drawn colorings differ")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = colorful_map_count(sp, drawn[0])
        torch.cuda.synchronize()
        singles[t.name] = time.perf_counter() - t0
        single_s += singles[t.name]
        bitwise &= torch.equal(m, fam[:, r])
        rel = ((m - fam[:, r]).abs() / fam[:, r].abs().clamp(min=1)).max().item()
        worst = max(worst, rel)
        if rel > PLAIN_RTOL:
            raise AssertionError(f"{tag}: {t.name}'s own plan {m.tolist()} vs the family "
                                 f"{fam[:, r].tolist()} beyond rtol {PLAIN_RTOL}")
        del sp
    torch.cuda.empty_cache()
    fam_s = predrawn[False] * batch
    log(f"{tag}: each template's own plan (n_colors={plan.k}) == the family's maps: bitwise "
        f"{bitwise}, largest relative difference {worst:.3e}; one pre-drawn batch of the family "
        f"{fam_s * 1e3:.1f} ms against the sum of the {len(names)} single-template passes "
        f"{single_s * 1e3:.1f} ms ({', '.join(f'{k} {v * 1e3:.1f}' for k, v in singles.items())})")
    # coloring 0 of call 0 through the plain versions on the card
    plain = plain_counts(plan, dag, draw_colorings(plan, batch, call_key(key, 0))[:1])
    for r, name in enumerate(names):
        p, k_ = plain[r].item(), fam[0, r].item()
        if not math.isclose(p, k_, rel_tol=PLAIN_RTOL):
            raise AssertionError(f"{tag} {name}: kernels {k_} vs plain versions {p} beyond "
                                 f"rtol {PLAIN_RTOL}")
    log(f"{tag}: fused == unfused bitwise over {batch * calls} colorings; launches {launches}; "
        f"plain versions within rtol {PLAIN_RTOL} on coloring 0: "
        f"{dict(zip(names, (x.item() for x in plain)))}")
    per = {("fused" if fu else "unfused"): {"ms_per_coloring": dt / (batch * calls) * 1e3,
                                             "predrawn_ms_per_coloring": predrawn[fu] * 1e3,
                                             "peak_bytes": peak}
           for fu, (_, dt, peak) in results.items()}
    return launches, {"templates": names, "k": plan.k, "batch": batch, "calls": calls,
                      "dag_nodes": len(dag.nodes), "internal_nodes": len(dag.internal_nodes()),
                      "chain_internal_nodes": sum(len(template_program(t).internal_nodes())
                                                  for t in plan.templates),
                      "single_plans_bitwise": bitwise, "single_plans_max_rel": worst,
                      "family_predrawn_batch_ms": fam_s * 1e3,
                      "single_plans_ms": {k: v * 1e3 for k, v in singles.items()}} | per


def phase_family(g, dev):
    """Phase 9: the rmat500-family row's templates at k = 10 on the main
    cell's graph."""
    import torch
    from repro_torch.configs.subgraph import COUNTING_CONFIGS
    from repro_torch.core.count_engine import build_multi_counting_plan

    names = COUNTING_CONFIGS["rmat500-family"].templates
    t0 = time.perf_counter()
    plan = build_multi_counting_plan(g, names, n_colors=FAMILY_K, device=dev)
    log(f"phase 9 family {names} k={plan.k}: {len(plan.dag.nodes)} DAG nodes, "
        f"{len(plan.dag.internal_nodes())} internal; plan in {time.perf_counter() - t0:.1f}s")
    rows = dag_kernel_rows(plan, FAMILY_BATCH, "phase 9")
    launches, path = phase_dag("phase 9", g, plan, FAMILY_BATCH, FAMILY_CALLS)
    del plan
    torch.cuda.empty_cache()
    return launches, rows, path


def phase_tw2(dev):
    """Phase 10: the bench-tw2-mixed row's family at k = 6 on R-MAT
    2^13 / 64,000, then Counter.estimate of cycle6 alone on that graph."""
    import numpy as np
    import torch
    from repro_torch.api import Counter
    from repro_torch.configs.subgraph import COUNTING_CONFIGS
    from repro_torch.core import prng
    from repro_torch.core.count_engine import build_multi_counting_plan, count_fn_many
    from repro_torch.core.estimator import call_key

    g = rmat_graph(*TW2_GRAPH)
    names = COUNTING_CONFIGS["bench-tw2-mixed"].templates
    t0 = time.perf_counter()
    plan = build_multi_counting_plan(g, names, n_colors=TW2_K, device=dev)
    kinds = [nd.kind for nd in plan.dag.nodes]
    log(f"phase 10 family {names} k={plan.k}: {len(kinds)} DAG nodes "
        f"{ {k: kinds.count(k) for k in sorted(set(kinds))} }, widest bag table "
        f"{plan.n_pad * TW2_BATCH * max(plan.widths.values())} elements; plan in "
        f"{time.perf_counter() - t0:.1f}s")
    rows = dag_kernel_rows(plan, TW2_BATCH, "phase 10")
    launches, path = phase_dag("phase 10", g, plan, TW2_BATCH, TW2_CALLS)
    key = prng.key(0)
    fam_est = count_fn_many(plan, TW2_BATCH)(call_key(key, 0))[1][:, list(names).index("cycle6")]
    del plan
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    counter = Counter.from_graph(g, "cycle6", device=dev)
    counter.sample_fn(key, TW2_BATCH)  # the plan, outside the timer
    t0 = time.perf_counter()
    res = counter.estimate(n_iter=2 * TW2_BATCH, batch=TW2_BATCH, key=key)
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if res.samples.shape != (2 * TW2_BATCH,) or not np.isfinite(res.samples).all():
        raise AssertionError(f"phase 10 cycle6 estimate: bad samples {res.samples}")
    got = torch.from_numpy(res.samples[:TW2_BATCH]).to(dev)
    if not torch.allclose(got, fam_est, rtol=PLAIN_RTOL, atol=0):
        raise AssertionError(f"cycle6 alone {got.tolist()} vs the family {fam_est.tolist()}")
    log(f"phase 10 Counter.estimate cycle6: {2 * TW2_BATCH} colorings in {dt:.2f}s "
        f"({dt / (2 * TW2_BATCH) * 1e3:.1f} ms/coloring), peak {peak} bytes, estimate "
        f"{res.estimate:.6g} RSD {res.relative_sd:.3f}; samples == the family's cycle6 column "
        f"bitwise {torch.equal(got, fam_est)}")
    path["cycle6_estimate"] = {"ms_per_coloring": dt / (2 * TW2_BATCH) * 1e3, "peak_bytes": peak,
                               "estimate": res.estimate}
    del counter
    torch.cuda.empty_cache()
    return launches, rows, path


# ---------------------------------------------------------------------------
# phase 11: active-frontier compaction


#: the compact routes, each one kernel launch a call: the edge SpMM on a
#: compact source, the fused kernel on one, the combine on gathered rows
ROUTES = ("spmm_compact", "fused_count_compact", "compact_combine")


@contextlib.contextmanager
def route_counts():
    """Calls of the three compact routes while the block runs (each call
    launches its kernel once), counted by wrapping the names the executor
    calls them by; restored after."""
    from repro_torch.core import table_program
    from repro_torch.kernels import ops

    counts = dict.fromkeys(ROUTES, 0)
    saved = [(ops, "spmm_compact"), (ops, "fused_count_compact"),
             (table_program, "compact_combine")]
    originals = [getattr(mod, name) for mod, name in saved]

    def counted(name, fn):
        def call(*args, **kwargs):
            counts[name] += 1
            return fn(*args, **kwargs)
        return call

    for (mod, name), fn in zip(saved, originals):
        setattr(mod, name, counted(name, fn))
    try:
        yield counts
    finally:
        for (mod, name), fn in zip(saved, originals):
            setattr(mod, name, fn)


def compact_prediction(plan, batch: int, fuse: bool):
    """What one call of the compact program launches, from the spec: the
    routes, the kernels, and the kernels of its dense twin.  A node with a
    combine cap takes SpMM then the combine on gathered rows; else fused
    or SpMM then combine; its SpMM or fused kernel reads a compact source
    where the right child has a table cap whose union table, ``B (cap - 1)
    + 1`` rows, is shorter than ``n_pad``."""
    spec = plan.compaction
    routes = dict.fromkeys(ROUTES, 0)
    kernels = dict.fromkeys(("spmm_edgetile", "color_combine", "fused_count"), 0)
    dense = dict(kernels)
    for i, nd in plan.chain.internal_nodes():
        cap = spec.table_caps.get(nd.right)
        src = int(cap is not None and batch * (cap - 1) + 1 < plan.n_pad)
        two_step = ("spmm_edgetile", "color_combine")
        for k in (("fused_count",) if fuse else two_step):
            dense[k] += 1
        if i in spec.combine_caps:
            routes["compact_combine"] += 1
            routes["spmm_compact"] += src
        elif fuse:
            routes["fused_count_compact"] += src
        else:
            routes["spmm_compact"] += src
        for k in (("fused_count",) if fuse and i not in spec.combine_caps else two_step):
            kernels[k] += 1
    return routes, kernels, dense


def capture_activity(plan, colorings, nodes):
    """The active (vertex, coloring) rows of the left and right tables that
    ``nodes`` read in one pass of the compact program over ``colorings``,
    and the pass's flags ``ok [B]``."""
    import torch
    from repro_torch.core.frontier import make_frontier_fn
    from repro_torch.core.table_program import (leaf_table, local_node_fn, root_count,
                                                run_table_program)

    spec, flags, seen = plan.compaction, [], {}
    base = local_node_fn(plan.spmm_plan, compaction=spec, sentinel_row=plan.n, flags=flags)

    def node_fn(i, tbl, c_left, c_right, f_left, f_right):
        if i in nodes:
            seen[i] = (c_left.amax(-1) > 0, c_right.amax(-1) > 0)
        return base(i, tbl, c_left, c_right, f_left, f_right)

    run_table_program(plan.chain, plan.combine, leaf_table(colorings, plan.k, plan.n), plan.n,
                      node_fn, root_fn=root_count,
                      frontier_fn=make_frontier_fn(spec.table_caps, plan.n, flags))
    ok = torch.stack(flags).all(dim=0) if flags else torch.ones(colorings.shape[0], dtype=bool)
    return seen, ok


def sparse_source_rows(plan, i: int, masks, gen, rows, ops_ms, tag: str):
    """Node ``i`` reads a compact source: the edge and fused kernels on the
    ``[B (cap - 1) + 1, B, W]`` union table through remapped columns, each
    == its plain version on the same compact source (exact: 0/1 tables on
    the DP's own active rows keep every sum below 2^24) and == its dense
    run bitwise; timed beside the plain version, the library call where one
    exists and the bound.  The compact ops' pieces (frontier, gather,
    remap) and the dense ops are timed into ``ops_ms``."""
    import torch
    from repro_torch.core.frontier import make_frontier_fn
    from repro_torch.kernels import ops, ref, work
    from repro_torch.kernels.fused_count import fused_count
    from repro_torch.kernels.spmm_edgetile import spmm_edge_tile

    sp, tbl, nd = plan.spmm_plan, plan.combine[i], plan.chain.nodes[i]
    cap = plan.compaction.table_caps[nd.right]
    l_act, r_act = masks[i]
    n_pad, batch = r_act.shape
    dev = r_act.device

    def table(act, width):
        return torch.randint(0, 2, (n_pad, batch, width), generator=gen, device=dev).float() \
            * act[..., None]

    right = table(r_act, tbl.w)
    flags = []
    frontier_fn = make_frontier_fn({nd.right: cap}, plan.n, flags)
    fr = frontier_fn(nd.right, right)
    if fr.idx is None or not bool(flags[0].all()):
        raise AssertionError(f"{tag} node {i}: no compact source (flags {flags[0].tolist()})")
    rows_c = fr.idx.numel()
    right_c = right.index_select(0, fr.idx)
    cols = torch.index_select(fr.inv, 0, sp.indices)
    e, width = sp.num_directed, batch * tbl.w
    shape = f"node {i} A={tbl.a} B={tbl.w} S={tbl.s} J={tbl.j} source {rows_c}/{n_pad} rows"
    got = spmm_edge_tile(sp.indptr, cols, right_c)
    err = max_abs_err(got, ref.spmm_segment_ref(sp.indptr, cols, right_c))
    dense_equal = torch.equal(got, spmm_edge_tile(sp.indptr, sp.indices, right))
    ops_equal = torch.equal(got, ops.spmm_compact(sp, right_c, fr.inv))
    del got
    if err != 0 or not dense_equal or not ops_equal:
        raise AssertionError(f"{tag} spmm_edgetile on a compact source at {shape}: err {err}, "
                             f"== dense {dense_equal}, == spmm_compact {ops_equal}")
    csr = torch.sparse_csr_tensor(sp.indptr, cols.long(), torch.ones(e, device=dev),
                                  (n_pad, rows_c))
    flat = right_c.view(rows_c, -1)
    rows["spmm_edgetile"].append(dict(
        shape=shape, mult=1, err=err,
        ms=cuda_ms(lambda: spmm_edge_tile(sp.indptr, cols, right_c)),
        plain_ms=cuda_ms(lambda: ref.spmm_segment_ref(sp.indptr, cols, right_c), 1),
        library_ms=cuda_ms(lambda: torch.sparse.mm(csr, flat)),
        bound=bound_ms(work.spmm_edge(n_pad, rows_c, e, width)), gather_ms=hbm_ms(e * width * 4)))
    del csr, flat
    ops_ms.update({
        "frontier_ms": cuda_ms(lambda: frontier_fn(nd.right, right)),
        "source_gather_ms": cuda_ms(lambda: right.index_select(0, fr.idx)),
        "remap_ms": cuda_ms(lambda: torch.index_select(fr.inv, 0, sp.indices)),
        "spmm_compact_ms": cuda_ms(lambda: ops.spmm_compact(sp, right_c, fr.inv)),
        "spmm_dense_ms": cuda_ms(lambda: ops.spmm(sp, right))})
    left = table(l_act, tbl.a)
    got = fused_count(sp.indptr, cols, left, right_c, tbl)
    err = max_abs_err(got, ref.fused_count_ref(sp.indptr, cols, left, right_c, tbl.idx1,
                                               tbl.idx2))
    dense_equal = torch.equal(got, fused_count(sp.indptr, sp.indices, left, right, tbl))
    ops_equal = torch.equal(got, ops.fused_count_compact(sp, left, right_c, fr.inv, tbl))
    del got
    if err != 0 or not dense_equal or not ops_equal:
        raise AssertionError(f"{tag} fused_count on a compact source at {shape}: err {err}, "
                             f"== dense {dense_equal}, == fused_count_compact {ops_equal}")
    rows["fused_count"].append(dict(
        shape=shape, mult=1, err=err,
        ms=cuda_ms(lambda: fused_count(sp.indptr, cols, left, right_c, tbl)),
        plain_ms=cuda_ms(lambda: ref.fused_count_ref(sp.indptr, cols, left, right_c, tbl.idx1,
                                                     tbl.idx2), 1),
        library_ms=None,
        bound=bound_ms(work.fused_count(n_pad, rows_c, e, batch, tbl.a, tbl.w, tbl.s, tbl.j,
                                        tbl.jp)),
        gather_ms=hbm_ms(e * width * 4)))
    ops_ms.update({
        "fused_count_compact_ms": cuda_ms(lambda: ops.fused_count_compact(sp, left, right_c,
                                                                          fr.inv, tbl)),
        "fused_count_dense_ms": cuda_ms(lambda: ops.fused_count(sp.indptr, sp.indices, left,
                                                                right, tbl))})
    log(f"{tag} {shape}: spmm_edgetile {rows['spmm_edgetile'][-1]['ms']:.3f}ms, fused_count "
        f"{rows['fused_count'][-1]['ms']:.3f}ms on the compact source == plain and == dense; "
        f"ops {ops_ms}")
    del left, right, right_c, cols, fr
    torch.cuda.empty_cache()


def sparse_combine_rows(plan, i: int, masks, gen, rows, ops_ms, tag: str):
    """Node ``i`` has a combine cap: the combine kernel on the gathered
    ``[B (cap - 1) + 1, 1, A]`` rows == its plain version on them (exact,
    0/1 tables on the DP's own active rows), and ``compact_combine`` == the
    dense combine bitwise; timed beside the plain version and the bound,
    and the compact op's pieces (masks, row slots, gather, the output laid
    back out) into ``ops_ms``."""
    import torch
    from repro_torch.core.frontier import combine_rows, compact_combine, inverse_map
    from repro_torch.kernels import ops, ref, work
    from repro_torch.kernels.color_combine import color_combine

    sp, tbl = plan.spmm_plan, plan.combine[i]
    cap = plan.compaction.combine_caps[i]
    l_act, r_act = masks[i]
    n_pad, batch = r_act.shape
    dev = r_act.device

    def table(act, width):
        return torch.randint(0, 2, (n_pad, batch, width), generator=gen, device=dev).float() \
            * act[..., None]

    left = table(l_act, tbl.a)
    m = ops.spmm(sp, table(r_act, tbl.w))
    act = (left.amax(-1) > 0) & (m.amax(-1) > 0)
    if not bool((act.sum(0) <= cap - 1).all()):
        raise AssertionError(f"{tag} node {i}: {act.sum(0).tolist()} active rows, cap {cap}")
    idx = combine_rows(act, cap, plan.n)
    r = idx.numel()
    lc = left.view(-1, tbl.a).index_select(0, idx).view(r, 1, tbl.a)
    mc = m.view(-1, tbl.w).index_select(0, idx).view(r, 1, tbl.w)
    got = color_combine(lc, mc, tbl)
    err = max_abs_err(got, ref.color_combine_ref(lc, mc, tbl.idx1, tbl.idx2))
    flags = []
    whole = compact_combine(left, m, tbl, cap, plan.n, flags)
    dense_equal = torch.equal(whole, color_combine(left, m, tbl)) and bool(flags[0].all())
    del got, whole
    shape = (f"node {i} A={tbl.a} B={tbl.w} S={tbl.s} J={tbl.j} rows {r}/{n_pad * batch} "
             f"({int(act.sum())} active)")
    if err != 0 or not dense_equal:
        raise AssertionError(f"{tag} color_combine on gathered rows at {shape}: err {err}, "
                             f"compact_combine == dense {dense_equal}")
    rows["color_combine"].append(dict(
        shape=shape, mult=1, err=err,
        ms=cuda_ms(lambda: color_combine(lc, mc, tbl)),
        plain_ms=cuda_ms(lambda: ref.color_combine_ref(lc, mc, tbl.idx1, tbl.idx2), 1),
        library_ms=None,
        bound=bound_ms(work.color_combine(r, tbl.a, tbl.w, tbl.s, tbl.j, tbl.jp)),
        gather_ms=None))

    outc = lc.new_zeros((r, tbl.s))
    inv = inverse_map(act.reshape(-1), r - 1)  # no coloring overflows here: keep == act

    ops_ms.update({
        "masks_ms": cuda_ms(lambda: (left.amax(-1) > 0) & (m.amax(-1) > 0)),
        "row_slots_ms": cuda_ms(lambda: combine_rows(act, cap, plan.n)),
        "row_gather_ms": cuda_ms(lambda: (left.view(-1, tbl.a).index_select(0, idx),
                                          m.view(-1, tbl.w).index_select(0, idx))),
        "output_ms": cuda_ms(lambda: outc.index_select(0, inv)),
        "compact_combine_ms": cuda_ms(lambda: compact_combine(left, m, tbl, cap, plan.n, [])),
        "combine_dense_ms": cuda_ms(lambda: color_combine(left, m, tbl))})
    log(f"{tag} {shape}: color_combine {rows['color_combine'][-1]['ms']:.3f}ms on the gathered "
        f"rows == plain; compact_combine == dense; ops {ops_ms}")
    del left, m, lc, mc, act, idx, outc, inv
    torch.cuda.empty_cache()


def sparse_cell(name: str, dev, g):
    """One compacted row at 2^22 vertices: its compact and dense plans, the
    spec and the probe's seconds; the compact routes' kernels against their
    plain versions at an engaged node each; count_fn compact and dense,
    unfused and fused, SPARSE_CALLS calls each from one key after one call
    outside the timer, the maps bitwise equal, the routes and launches as the spec predicts; the flags
    of every call; one call under the compaction.overflow fault."""
    import torch
    from repro_torch.configs.subgraph import COUNTING_CONFIGS
    from repro_torch.core import prng
    from repro_torch.core.count_engine import (build_counting_plan, colorful_map_count_checked,
                                               count_fn, draw_colorings)
    from repro_torch.core.estimator import call_key
    from repro_torch.core.frontier import single_device_compaction
    from repro_torch.core.templates import template
    from repro_torch.testing import faults

    tag = f"phase 11 {name}"
    row = COUNTING_CONFIGS[name]
    tree = template(row.template)
    times = {}

    def timed_plan(mode, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p = build_counting_plan(g, tree, device=dev, **kw)
        torch.cuda.synchronize()
        times[mode] = time.perf_counter() - t0
        return p

    dense = timed_plan("dense")
    plan = timed_plan("compact", compact=True, density_threshold=row.density_threshold,
                      capacity_factor=row.capacity_factor)
    spec = plan.compaction
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    again = single_device_compaction(g, plan.chain, plan.combine, plan.k, n_pad=plan.n_pad,
                                     threshold=row.density_threshold,
                                     capacity_factor=row.capacity_factor)
    probe_s = time.perf_counter() - t0  # the spec's host copy ends the probe
    if again != spec or not spec.enabled:
        raise AssertionError(f"{tag}: spec {spec}, probed again {again}")
    log(f"{tag}: plans dense {times['dense']:.2f}s, compact {times['compact']:.2f}s; the probe "
        f"(2 colorings, one batched DP pass) {probe_s:.3f}s; densities "
        f"{ {i: round(d, 4) for i, d in spec.density.items()} }, gather densities "
        f"{ {i: round(d, 4) for i, d in spec.gather_density.items()} }, table caps "
        f"{dict(spec.table_caps)}, combine caps {dict(spec.combine_caps)}")
    key = prng.key(0)
    batch, calls = SPARSE_BATCH, SPARSE_CALLS
    # the compact routes' kernels at one engaged node each, on the DP's own
    # active rows of call 0
    # a node reading a compact source (one without a combine cap first: the
    # fused kernel reads its source under fuse) and a node with a combine cap
    src_nodes = sorted((i in spec.combine_caps, i) for i, nd in plan.chain.internal_nodes()
                       if nd.right in spec.table_caps
                       and batch * (spec.table_caps[nd.right] - 1) + 1 < plan.n_pad)
    src_nodes = [i for _, i in src_nodes]
    comb_nodes = sorted(spec.combine_caps)
    nodes = src_nodes[:1] + comb_nodes[:1]
    masks, ok0 = capture_activity(plan, draw_colorings(plan, batch, call_key(key, 0)), set(nodes))
    if not bool(ok0.all()):
        raise AssertionError(f"{tag}: call 0 overflowed ({ok0.tolist()}); no node to check")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    rows = {"spmm_edgetile": [], "color_combine": [], "fused_count": []}
    ops_ms = {}
    if src_nodes:
        sparse_source_rows(plan, src_nodes[0], masks, gen, rows, ops_ms, tag)
    if comb_nodes:
        sparse_combine_rows(plan, comb_nodes[0], masks, gen, rows, ops_ms, tag)
    del masks
    torch.cuda.empty_cache()
    # count_fn, compact then dense, unfused then fused
    launches = {k: 0 for k in read_launches()}
    routes_seen = dict.fromkeys(ROUTES, 0)
    runs, maps_of = {}, {}
    for fuse in (False, True):
        for mode, base in (("compact", plan), ("dense", dense)):
            p = dataclasses.replace(base, fuse=fuse)
            f = count_fn(p, batch)
            # one call outside the timer, so that neither mode pays for the
            # allocator's first allocations of these shapes
            f(call_key(key, 0))
            warm_fallbacks = getattr(f, "fallbacks", 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_launches()
            with route_counts() as routes:
                t0 = time.perf_counter()
                maps = torch.cat([f(call_key(key, c))[0] for c in range(calls)])
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            launched = read_launches()
            peak = torch.cuda.max_memory_allocated(dev)
            if maps.shape != (batch * calls,) or not torch.isfinite(maps).all():
                raise AssertionError(f"{tag} {mode} fuse={fuse}: bad maps {maps}")
            fallbacks = getattr(f, "fallbacks", 0) - warm_fallbacks
            if mode == "compact":
                want_routes, kernels, dense_kernels = compact_prediction(plan, batch, fuse)
                want_routes = {k: v * calls for k, v in want_routes.items()}
                want = {k: 0 for k in launched}
                for k in kernels:
                    want[k] = calls * kernels[k] + fallbacks * dense_kernels[k]
                if routes != want_routes or launched != want:
                    raise AssertionError(f"{tag} fuse={fuse}: routes {routes} launches "
                                         f"{launched}; the spec predicts {want_routes} "
                                         f"{want} ({fallbacks} fallbacks)")
                for k in launches:
                    launches[k] += launched[k]
                for k in ROUTES:
                    routes_seen[k] += routes[k]
            elif any(routes.values()):
                raise AssertionError(f"{tag}: the dense twin took a compact route {routes}")
            key_ = f"{mode}_{'fused' if fuse else 'unfused'}"
            runs[key_] = {"ms_per_coloring": dt / (batch * calls) * 1e3, "peak_bytes": peak,
                          "fallbacks": fallbacks, "routes": dict(routes), "launches": launched}
            maps_of[key_] = maps
            log(f"{tag} {mode} fuse={fuse}: {batch * calls} colorings in {dt:.3f}s "
                f"({dt / (batch * calls) * 1e3:.2f} ms/coloring), peak {peak} bytes, "
                f"{fallbacks} fallbacks, routes {dict(routes)}, launches {launched}")
    for fuse in ("unfused", "fused"):
        if not torch.equal(maps_of[f"compact_{fuse}"], maps_of[f"dense_{fuse}"]):
            raise AssertionError(f"{tag} {fuse}: compact {maps_of[f'compact_{fuse}'].tolist()} "
                                 f"!= dense {maps_of[f'dense_{fuse}'].tolist()}")
    if not torch.equal(maps_of["compact_unfused"], maps_of["compact_fused"]):
        raise AssertionError(f"{tag}: fused and unfused maps differ")
    flags = [colorful_map_count_checked(plan, draw_colorings(plan, batch, call_key(key, c)))[1]
             .tolist() for c in range(calls)]
    # one call under the fault site: the dense twin runs on the card, == dense
    f = count_fn(plan, batch)
    with faults.active(faults.inject("compaction.overflow", at=None)) as fired:
        forced = f(call_key(key, 0))[0]
    if (not fired.fired or f.fallbacks != 1 or forced.device.type != dev.type
            or not torch.equal(forced, maps_of["dense_unfused"][:batch])):
        raise AssertionError(f"{tag}: the overflow fault gave {forced} ({f.fallbacks} fallbacks)")
    log(f"{tag}: compact == dense bitwise, unfused and fused, over {batch * calls} colorings "
        f"(maps {maps_of['compact_unfused'].tolist()}); flags per call {flags}; under "
        f"compaction.overflow one call ran the dense twin on the card and == dense")
    summary = {"graph": {"n": g.n, "e_directed": g.num_directed, "max_degree": g.max_degree,
                         "skew": row.skew},
               "template": row.template, "batch": batch, "calls": calls, "n_pad": plan.n_pad,
               "plan_s": times, "probe_s": probe_s,
               "spec": {"threshold": spec.threshold, "capacity_factor": spec.capacity_factor,
                        "density": dict(spec.density),
                        "gather_density": dict(spec.gather_density),
                        "table_caps": dict(spec.table_caps),
                        "combine_caps": dict(spec.combine_caps)},
               "flags": flags, "runs": runs, "ops_ms": ops_ms,
               "checked_nodes": nodes}
    del plan, dense, g
    torch.cuda.empty_cache()
    return launches, routes_seen, rows, summary


def phase_sparse(dev, graphs):
    """Phase 11: both compacted rows; every compact route must have run.
    ``graphs`` (name -> R-MAT) is filled here and read again by phase 13."""
    from repro_torch.configs.subgraph import COUNTING_CONFIGS

    launches, routes, rows, cells = None, dict.fromkeys(ROUTES, 0), None, {}
    for name in SPARSE_GRAPHS:
        graphs[name] = rmat_graph(*SPARSE_GRAPHS[name], skew=COUNTING_CONFIGS[name].skew)
        l, r, cell_rows, cells[name] = sparse_cell(name, dev, graphs[name])
        launches = l if launches is None else {k: launches[k] + l[k] for k in l}
        routes = {k: routes[k] + r[k] for k in ROUTES}
        rows = cell_rows if rows is None else {k: rows[k] + cell_rows[k] for k in rows}
    if not all(routes.values()) or not all(rows.values()):
        raise AssertionError(f"phase 11: a compact route never ran ({routes}) or was never "
                             f"checked ({ {k: len(v) for k, v in rows.items()} })")
    return launches, rows, {"cells": cells, "routes": routes}


# ---------------------------------------------------------------------------
# phase 12: the distributed exchange engine
# ---------------------------------------------------------------------------

#: every exchange mode, the pipeline at group factors 1 and 3
DIST_MODES = (("alltoall", 1), ("pipeline", 1), ("pipeline", 3), ("adaptive", 1), ("ring", 1))
#: (a): LocalMesh shapes (data ranks, iteration ranks) on the card; (4, 2)
#: and (8, 1) cut for time in PR 25 (the CPU tests hold every P x I)
DIST_EXACT_MESHES = ((4, 1), (8, 2))
#: (a): the reference worker's graph, and a skew-8 R-MAT whose u5-2 count
#: (1,942,968 on the coloring) stays below 2^24 and whose brute force takes
#: seconds
DIST_EXACT_RMAT = (4096, 1200)
DIST_FAMILIES = (("u3-1", "u5-2", "u7-2"), ("cycle4",), ("diamond",),
                 ("u3-1", "cycle4", "u5-2", "diamond"))
#: (b): u12-2 on the main cell's graph over 4 thread ranks of the card.  A
#: shard's received alltoall buffer is P r_pad B W 4 bytes (r_pad = 174,976
#: there: 2.2 GB at W = 792 and B = 1) and its send buffer as much, for all
#: four ranks on the one card; the alltoall peak was 21.4 GB at B = 1, so
#: B = 2 (about 43 GB) fits
DIST_SHARDS = 4
DIST_BATCH = 2
DIST_RTOL = 1e-5
#: (b): the modes also run once under torch.profiler
DIST_PROFILED = ("alltoall", "pipeline-g1", "pipeline-g1 fused")
DIST_PEAK_CALLS = 2  # (b): calls a mode for its peak alone, after the warm and timed ones
#: (b): the node shape whose kernels are held on the shard's rectangular
#: alltoall CSR and a bucket CSR
DIST_CHECK_NODE = (12, 220, 495, 4)


def _dist_label(mode: str, gf: int) -> str:
    return f"pipeline-g{gf}" if mode == "pipeline" else mode


def dist_exact(dev):
    """(a): every mode x fuse on LocalMesh P in {4, 8}, I in {1, 2} == brute
    force; families and treewidth-2 rows == the single-device port; keyed
    samples of P = 1 == P = 8."""
    import numpy as np
    from repro_torch.comm import LocalMesh
    from repro_torch.core import prng
    from repro_torch.core.brute_force import count_colorful_maps
    from repro_torch.core.count_engine import build_multi_counting_plan, colorful_map_count_many
    from repro_torch.core.distributed import (build_distributed_plan, keyed_sample_fn,
                                              make_count_fn, shard_coloring)
    from repro_torch.core.graphs import erdos_renyi, rmat
    from repro_torch.core.templates import path_tree, spider_tree, template

    er = erdos_renyi(97, 5.0, seed=7)
    skew = rmat(*DIST_EXACT_RMAT, skew=8, seed=2)
    calls = 0
    t0 = time.perf_counter()
    for g in (er, skew):
        for name, tree in (("p4", path_tree(4)), ("sp21", spider_tree([2, 1])),
                           ("u5-2", template("u5-2"))):
            col = np.random.default_rng(3).integers(0, tree.n, g.n).astype(np.int32)
            want = count_colorful_maps(g, tree, col)
            for P, I in DIST_EXACT_MESHES:
                plan = build_distributed_plan(g, tree, P, device=dev)
                mesh = LocalMesh(P, I, device=dev)
                cols = np.broadcast_to(shard_coloring(plan, col)[None], (I, P, plan.n_loc_pad))
                for mode, gf in DIST_MODES:
                    for fuse in (False, True):
                        got = make_count_fn(plan, mesh, mode=mode, group_factor=gf,
                                            fuse=fuse)(cols).tolist()
                        calls += 1
                        if got != [want] * I:
                            raise AssertionError(f"phase 12 {g.name} {name} P={P} I={I} "
                                                 f"{_dist_label(mode, gf)} fuse={fuse}: {got} "
                                                 f"!= brute force {want}")
            log(f"phase 12 (a) {g.name} {name}: {want} colorful maps; every mode x fuse on "
                f"LocalMesh {DIST_EXACT_MESHES} == brute force")
    for fam in DIST_FAMILIES:
        temps = [template(t) for t in fam]
        single = build_multi_counting_plan(er, temps, device=dev)
        col = np.random.default_rng(5).integers(0, single.k, er.n).astype(np.int32)
        want = colorful_map_count_many(single, col).tolist()
        for P, I in ((4, 1), (8, 2)):
            plan = build_distributed_plan(er, temps, P, device=dev)
            mesh = LocalMesh(P, I, device=dev)
            cols = np.broadcast_to(shard_coloring(plan, col)[None], (I, P, plan.n_loc_pad))
            for mode, gf in DIST_MODES:
                for fuse in (False, True):
                    got = make_count_fn(plan, mesh, mode=mode, group_factor=gf,
                                        fuse=fuse)(cols).tolist()
                    calls += 1
                    if got != [want] * I:
                        raise AssertionError(f"phase 12 family {fam} P={P} I={I} "
                                             f"{_dist_label(mode, gf)} fuse={fuse}: {got} != "
                                             f"the single-device port's {want}")
        log(f"phase 12 (a) family {fam} (k={single.k}): {want}; every mode x fuse on P=4 and "
            f"8x2 == the single-device port")
    samples = []
    for P in (1, 8):
        plan = build_distributed_plan(skew, template("u5-2"), P, device=dev)
        samples.append(keyed_sample_fn(plan, LocalMesh(P, device=dev), mode="adaptive")(
            prng.key(7), 4))
    if not np.array_equal(samples[0], samples[1]):
        raise AssertionError(f"phase 12 keyed samples P=1 {samples[0]} != P=8 {samples[1]}")
    log(f"phase 12 (a): {calls} count calls exact in {time.perf_counter() - t0:.1f}s; keyed "
        f"samples P=1 == P=8 ({samples[0].tolist()})")
    return {"count_calls": calls, "seconds": time.perf_counter() - t0}


def _rect_tensor(csr, cols: int):
    """A rectangular CSR as ``torch.sparse_csr_tensor`` (the library
    yardstick); a bucket's offsets are rebased to its own edges."""
    import torch

    start, end = int(csr.indptr[0]), int(csr.indptr[-1])
    return torch.sparse_csr_tensor(csr.indptr - start, csr.indices[start:end].long(),
                                   torch.ones(end - start, device=csr.indptr.device),
                                   (csr.rows, cols))


def dist_kernel_rows(plan, dev, node=DIST_CHECK_NODE, phase="phase 12 (b)"):
    """(b): at the node of shape ``node`` (A, W, S, J), the edge and fused
    kernels on shard 0's rectangular alltoall CSR and on its bucket CSR from
    shard 1, and the combine on the shard's rows, == their plain versions on
    integer tables (sums below 2^24), timed beside them, the library call
    and the bound."""
    import torch
    from repro_torch.kernels import ops, ref, work

    i = next(i for i, t in plan.combine.items() if (t.a, t.w, t.s, t.j) == node)
    tbl = plan.combine[i]
    arrays = plan.shard_arrays(0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)
    b, rows_n = DIST_BATCH, plan.n_loc_pad
    rows = {"spmm_edgetile": [], "color_combine": [], "fused_count": []}

    def table(n, width, hi):
        return torch.randint(0, hi, (n, b, width), generator=gen, device=dev).float()

    for tag, csr, src_rows in (("alltoall CSR", arrays.a2a, plan.num_shards * plan.r_pad),
                               ("bucket CSR (1 -> 0)", arrays.buckets.csr(1, 0), plan.r_pad)):
        e = int(csr.indptr[-1] - csr.indptr[0])
        shape = f"{tag} rows={rows_n} source={src_rows} A={tbl.a} W={tbl.w} S={tbl.s} J={tbl.j}"
        src = table(src_rows, tbl.w, 4)
        got = ops.spmm_rect(csr, src)
        want = ref.spmm_segment_ref(csr.indptr, csr.indices, src)
        err = max_abs_err(got, want)
        lib = _rect_tensor(csr, src_rows)
        flat = src.reshape(src_rows, -1)
        lib_equal = torch.equal(torch.sparse.mm(lib, flat).reshape(got.shape), got)
        del got, want
        if err != 0 or not lib_equal:
            raise AssertionError(f"{phase} spmm_edgetile != plain on the {shape}: {err}, "
                                 f"library equal {lib_equal}")
        rows["spmm_edgetile"].append(dict(
            shape=shape, err=err, ms=cuda_ms(lambda: ops.spmm_rect(csr, src)),
            plain_ms=cuda_ms(lambda: ref.spmm_segment_ref(csr.indptr, csr.indices, src), 1),
            library_ms=cuda_ms(lambda: torch.sparse.mm(lib, flat)),
            bound=bound_ms(work.spmm_edge(rows_n, src_rows, e, b * tbl.w))))
        del src, flat
        left, src = table(rows_n, tbl.a, 2), table(src_rows, tbl.w, 2)
        got = ops.fused_count_rect(csr, left, src, tbl)
        want = ref.fused_count_ref(csr.indptr, csr.indices, left, src, tbl.idx1, tbl.idx2)
        err = max_abs_err(got, want)
        del got, want
        if err != 0:
            raise AssertionError(f"{phase} fused_count != plain on the {shape}: {err}")
        rows["fused_count"].append(dict(
            shape=shape, err=err, ms=cuda_ms(lambda: ops.fused_count_rect(csr, left, src, tbl)),
            plain_ms=cuda_ms(lambda: ref.fused_count_ref(csr.indptr, csr.indices, left, src,
                                                         tbl.idx1, tbl.idx2), 1),
            library_ms=None,
            bound=bound_ms(work.fused_count(rows_n, src_rows, e, b, tbl.a, tbl.w, tbl.s, tbl.j,
                                            tbl.jp))))
        del left, src
    left, m = table(rows_n, tbl.a, 4), table(rows_n, tbl.w, 4)
    got = ops.color_combine(left, m, tbl)
    err = max_abs_err(got, ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2))
    del got
    if err != 0:
        raise AssertionError(f"{phase} color_combine != plain on the shard's rows: {err}")
    shape = f"shard rows={rows_n} A={tbl.a} W={tbl.w} S={tbl.s} J={tbl.j}"
    rows["color_combine"].append(dict(
        shape=shape, err=err, ms=cuda_ms(lambda: ops.color_combine(left, m, tbl)),
        plain_ms=cuda_ms(lambda: ref.color_combine_ref(left, m, tbl.idx1, tbl.idx2), 1),
        library_ms=None,
        bound=bound_ms(work.color_combine(rows_n * b, tbl.a, tbl.w, tbl.s, tbl.j, tbl.jp))))
    del left, m
    for name, rs in rows.items():
        for r in rs:
            log(f"{phase} {name} on the {r['shape']}: {r['ms']:.3f}ms (plain "
                f"{r['plain_ms']:.1f}, library {r['library_ms']}, bound {r['bound'][0]:.3f} "
                f"{r['bound'][1]}) == plain")
    torch.cuda.empty_cache()
    return rows


def _predicted_launches(plan, node_modes, fuse: bool, calls: int) -> dict:
    """Kernel launches of ``calls`` count calls: on every rank, a node is one
    launch over the alltoall buffer or one a received chunk (P), plus one
    combine unfused."""
    P = plan.num_shards
    want = {"spmm_edgetile": 0, "color_combine": 0, "fused_count": 0}
    for i, mode in node_modes.items():
        per_rank = 1 if mode == "alltoall" else P
        if fuse:
            want["fused_count"] += P * per_rank
        else:
            want["spmm_edgetile"] += P * per_rank
            want["color_combine"] += P
    return {k: v * calls for k, v in want.items()}


def dist_full(g, dev):
    """(b): u12-2 at full width on LocalMesh P = 4, every mode x fuse, a warm
    then a timed call, against the single-device port on the same coloring,
    and DIST_PEAK_CALLS more for the peak alone."""
    import numpy as np
    import torch
    from repro_torch.comm import LocalMesh
    from repro_torch.core import prng
    from repro_torch.core.count_engine import build_counting_plan, colorful_map_count
    from repro_torch.core.distributed import (build_distributed_plan, global_coloring,
                                              make_count_fn, shard_coloring)
    from repro_torch.core.templates import template

    tree = template("u12-2")
    t0 = time.perf_counter()
    plan = build_distributed_plan(g, tree, DIST_SHARDS, device=dev)
    plan_s = time.perf_counter() - t0
    counts = plan.bucket_counts
    log(f"phase 12 (b) u12-2 plan P={DIST_SHARDS}: shard_size={plan.shard_size} "
        f"n_loc_pad={plan.n_loc_pad} r_pad={plan.r_pad} in {plan_s:.1f}s; bucket edges "
        f"{counts.min()}..{counts.max()} (diagonal {np.diag(counts).tolist()})")
    rows = dist_kernel_rows(plan, dev)
    mesh = LocalMesh(DIST_SHARDS, device=dev)
    single = build_counting_plan(g, tree, device=dev)
    key = prng.key(12)
    keys = prng.split(key, DIST_BATCH)
    col = torch.stack([global_coloring(k, g.n, plan.k, device=dev) for k in keys])  # [B, n]
    host = col.cpu().numpy()
    cols = np.stack([shard_coloring(plan, c) for c in host])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = colorful_map_count(single, col)
    torch.cuda.synchronize()
    single_ms = (time.perf_counter() - t0) * 1e3 / DIST_BATCH
    want = want.cpu()
    del single
    torch.cuda.empty_cache()
    results, launches_want = {}, {"spmm_edgetile": 0, "color_combine": 0, "fused_count": 0}
    reset_launches()
    for mode, gf in DIST_MODES:
        for fuse in (False, True):
            label = f"{_dist_label(mode, gf)}{' fused' if fuse else ''}"
            f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            f(cols)  # warm: the kernels' first launches and the allocator's blocks
            torch.cuda.synchronize()
            warm_peak = torch.cuda.max_memory_allocated(dev)
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            got = f(cols)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            if not torch.isfinite(got).all() or got.shape != (DIST_BATCH,):
                raise AssertionError(f"phase 12 (b) {label}: bad counts {got}")
            rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
            if rel > DIST_RTOL:
                raise AssertionError(f"phase 12 (b) {label}: {got.tolist()} vs single-device "
                                     f"{want.tolist()} beyond rtol {DIST_RTOL}")
            # more calls for the peak alone: whether the four thread ranks'
            # peaks coincide varies from call to call (pipeline-g1 26.47 to
            # 29.80 GB over six calls of one process), and phase 15 (c) holds
            # the most of them to its model
            peaks = [warm_peak, peak]
            for _ in range(DIST_PEAK_CALLS):
                torch.cuda.reset_peak_memory_stats(dev)
                f(cols)
                torch.cuda.synchronize()
                peaks.append(torch.cuda.max_memory_allocated(dev))
            calls = 2 + DIST_PEAK_CALLS
            split = None
            if label in DIST_PROFILED:
                # one more call under the profiler: the device's busy share
                # says how far the ranks' host work holds the card back
                split = device_split(lambda: f(cols))
                calls += 1
                log(f"phase 12 (b) {label} under the profiler: busy "
                    f"{split['device_busy_ms']:.1f} of {split['wall_ms']:.1f} ms "
                    f"({split['busy_share']:.1%}); top {split['top_kernels'][:4]}")
            for k, v in _predicted_launches(plan, f.node_modes, fuse, calls).items():
                launches_want[k] += v
            results[label] = {"ms_per_coloring": dt * 1e3 / DIST_BATCH, "peak_bytes": peak,
                              "peak_warm_and_timed_bytes": max(peak, warm_peak),
                              "peak_calls_bytes": peaks,
                              "allocated_before_bytes": base,
                              "bitwise_equal_single": bool(torch.equal(got, want)),
                              "max_rel_err": rel,
                              "node_modes": {str(i): m for i, m in f.node_modes.items()},
                              "device_split": split}
            log(f"phase 12 (b) {label}: {dt * 1e3 / DIST_BATCH:.1f} ms/coloring, peak "
                f"{peak} bytes ({base} before the call), counts {got.tolist()} vs single "
                f"{want.tolist()} (rel {rel:.2e}, bitwise {torch.equal(got, want)})")
    launches = read_launches()
    got_launches = {k: launches[k] for k in launches_want}
    if got_launches != launches_want or launches["spmm_block"] or launches["flash_attention"]:
        raise AssertionError(f"phase 12 (b) launches {launches}, the plan predicts "
                             f"{launches_want}")
    log(f"phase 12 (b): launches {got_launches} as the plan predicts (warm, timed and profiled "
        f"calls); "
        f"single-device u12-2 {single_ms:.1f} ms/coloring")
    torch.cuda.empty_cache()
    return launches, rows, {"modes": results, "single_device_ms_per_coloring": single_ms,
                            "plan_seconds": plan_s, "shards": DIST_SHARDS,
                            "batch": DIST_BATCH}, (plan, mesh, cols, want)


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def dist_nccl(dev, also=()):
    """(c): an NCCL group of world size 1 on the card (a TCPStore on
    localhost): every mode on (a)'s graphs == LocalMesh P = 1, each call's
    max_memory_allocated growth over the plan's resident arrays recorded
    (phase 15 (b) holds the dry-run's model to it); then calibrate on
    LocalMesh P = 4.  ``also``: checks of later phases that need the same
    NCCL world, each called as ``check(mesh, local)`` inside it, their
    results returned beside.  Also returns each plan on ``meta``."""
    import gc

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.comm import LocalMesh, ProcessGroupComm, ProcessMesh, SoloGroup, calibrate
    from repro_torch.core import prng
    from repro_torch.core.distributed import (build_distributed_plan, keyed_sample_fn,
                                              make_count_fn, shard_coloring)
    from repro_torch.core.graphs import erdos_renyi, rmat
    from repro_torch.core.templates import path_tree, template

    store = dist.TCPStore("localhost", _free_port(), 1, is_master=True)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    checked = 0
    growth, metas = [], {}
    try:
        mesh = ProcessMesh(ProcessGroupComm(), SoloGroup(), dev)
        local = LocalMesh(1, device=dev)
        for g in (erdos_renyi(97, 5.0, seed=7), rmat(*DIST_EXACT_RMAT, skew=8, seed=2)):
            for tree in (path_tree(4), template("u5-2"), template("cycle4")):
                plan = build_distributed_plan(g, tree, 1, device=dev)
                plan.shard_arrays(0, dev)  # resident before the calls, as after a first one
                metas[(g.name, tree.name)] = plan.to("meta")
                col = np.random.default_rng(3).integers(0, plan.k, g.n).astype(np.int32)
                cols = np.broadcast_to(shard_coloring(plan, col)[None], (2, 1, plan.n_loc_pad))
                for mode, gf in DIST_MODES:
                    for fuse in (False, True):
                        kw = dict(mode=mode, group_factor=gf, fuse=fuse)
                        f = make_count_fn(plan, mesh, **kw)
                        gc.collect()  # earlier count fns' cycles hold device bytes
                        torch.cuda.synchronize(dev)
                        base = torch.cuda.memory_allocated(dev)
                        torch.cuda.reset_peak_memory_stats(dev)
                        got = f(cols)
                        torch.cuda.synchronize(dev)
                        growth.append(dict(graph=g.name, tree=tree.name, mode=mode,
                                           group_factor=gf, fuse=fuse, growth_bytes=(
                                               torch.cuda.max_memory_allocated(dev) - base)))
                        want = make_count_fn(plan, local, **kw)(cols)
                        checked += 1
                        if got.tolist() != want.tolist():
                            raise AssertionError(f"phase 12 (c) NCCL {g.name} {tree.name} "
                                                 f"{kw}: {got} != LocalMesh {want}")
                a = keyed_sample_fn(plan, mesh)(prng.key(3), 2)
                if not np.array_equal(a, keyed_sample_fn(plan, local)(prng.key(3), 2)):
                    raise AssertionError("phase 12 (c) NCCL keyed samples != LocalMesh")
        later = [check(mesh, local) for check in also]
    finally:
        dist.destroy_process_group()
    log(f"phase 12 (c): NCCL at world size 1, {checked} count calls == LocalMesh P=1")
    t0 = time.perf_counter()
    model = calibrate(LocalMesh(4, device=dev))
    cal = {"alpha_s": model.alpha, "beta_s_per_byte": model.beta,
           "flops_per_s": model.flops_per_s, "seconds": time.perf_counter() - t0,
           "card": card_line()}
    log(f"phase 12 (c) calibrate on LocalMesh P=4 ({cal['card']}): alpha {model.alpha:.3e} s, "
        f"beta {model.beta:.3e} s/B ({1 / model.beta / 1e9:.1f} GB/s), matmul "
        f"{model.flops_per_s:.3e} flop/s, in {cal['seconds']:.1f}s")
    return {"nccl_count_calls": checked, "calibrate": cal, "growth": growth}, later, metas


def dist_launch():
    """(d): --mode adaptive at --shards 2 and 4 print identical estimates,
    within the RSD of --mode single."""
    base = ["--config", "bench-small", "--iters", "64", "--batch", "16"]
    two = _launch(base + ["--mode", "adaptive", "--shards", "2"])
    four = _launch(base + ["--mode", "adaptive", "--shards", "4"])
    single = _launch(base + ["--mode", "single"])
    if not _estimates(two) or _estimates(two) != _estimates(four):
        raise AssertionError(f"phase 12 (d): --shards 2 {two} vs --shards 4 {four}")

    def est(lines):
        mean_line = next(ln for ln in lines if ln.startswith("estimate (mean)"))
        mean = float(mean_line.split(":")[1].split()[0])
        return mean, float(mean_line.rsplit("RSD", 1)[1])

    (m_d, rsd_d), (m_s, rsd_s) = est(two), est(single)
    if abs(m_d - m_s) > max(rsd_d, rsd_s) * m_s:
        raise AssertionError(f"phase 12 (d): distributed mean {m_d} vs single {m_s} beyond "
                             f"the RSD ({rsd_d}, {rsd_s})")
    log(f"phase 12 (d): --shards 2 and 4 print identical estimates; mean {m_d:.6g} vs single "
        f"{m_s:.6g} (RSD {rsd_d}, {rsd_s})")
    return {"mean_distributed": m_d, "mean_single": m_s, "rsd": [rsd_d, rsd_s]}


def phase_distributed(g, dev):
    """Phase 12: (a)-(d), and phase 13 (c) on (b)'s plan and (d)'s NCCL
    check in (c)'s world; returns the path's launches, the kernel rows, a
    summary, phase 13's (c) and (d) NCCL results, and what phase 15 holds
    its model to: (b)'s u12-2 plan and (c)'s plans on ``meta``, and (c)'s
    growths."""
    t0 = time.perf_counter()
    exact = dist_exact(dev)
    launches, rows, full, u12 = dist_full(g, dev)
    saturation = compact_saturation(*u12)
    u12_meta = u12[0].to("meta")
    del u12
    nccl, (narrow_nccl,), metas = dist_nccl(dev, also=(compact_nccl,))
    launch = dist_launch()
    log(f"phase 12 passed in {time.perf_counter() - t0:.1f}s (with phase 13 (c) and the NCCL "
        f"part of (d))")
    model_inputs = {"u12": u12_meta, "nccl": metas, "growth": nccl["growth"]}
    return launches, rows, {"exact": exact, "full": full, "nccl": nccl, "launcher": launch}, \
        (saturation, narrow_nccl), model_inputs


# ---------------------------------------------------------------------------
# phase 13: the compacted exchange and the narrow wire
# ---------------------------------------------------------------------------

WIRES = ("float32", "int16", "int8")
#: the ladder a call climbs from its first rung (a compacted plan's, then a
#: dense one's): the programs a call ran are its rungs from start to end
LADDERS = (("int8 compact", "int16 compact", "float32 compact", "float32 dense"),
           ("int8 dense", "int16 dense", "float32 dense"))
#: (b): the modes run at full width (adaptive resolves to one of them per
#: node; pipeline g3 differs from g1 in the shifts a step posts)
COMPACT_MODES = (("alltoall", 1), ("pipeline", 1), ("ring", 1))
#: (b): (wire, compacted) settings of each mode x fuse
COMPACT_SETTINGS = (("float32", False), ("float32", True), ("int16", True))
COMPACT_SHARDS = 4
COMPACT_BATCH = 2


def programs_run(first: str, last: str) -> int:
    """How many programs a call ran, climbing from rung ``first`` to ``last``."""
    ladder = next(lad for lad in LADDERS if first in lad)
    return ladder.index(last) - ladder.index(first) + 1


def compact_saturation(plan, mesh, cols, want):
    """13 (c): u12-2 on the main cell's graph (phase 12 (b)'s plan and
    colorings, P = 4, B = 2), alltoall at int16 against float32, a warm then
    a timed call each: the rung reached, the time, counts == float32's."""
    import torch
    from repro_torch.core.distributed import make_count_fn

    out, got_of = {}, {}
    reset_launches()
    want_launches = {"spmm_edgetile": 0, "color_combine": 0, "fused_count": 0}
    for wire in ("float32", "int16"):
        f = make_count_fn(plan, mesh, mode="alltoall", wire_dtype=wire)
        f(cols)
        warm = f.rung
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = f(cols)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        ran = programs_run(f"{wire} dense", warm) + programs_run(f"{wire} dense", f.rung)
        for k, v in _predicted_launches(plan, f.node_modes, False, ran).items():
            want_launches[k] += v
        got_of[wire] = got
        out[wire] = {"ms_per_coloring": dt * 1e3 / got.shape[0], "rung": f.rung,
                     "warm_rung": warm, "peak_bytes": torch.cuda.max_memory_allocated()}
        log(f"phase 13 (c) u12-2 alltoall {wire}: {dt * 1e3 / got.shape[0]:.1f} ms/coloring, "
            f"ended on {f.rung} (warm call {warm}), peak {out[wire]['peak_bytes']} bytes")
    launches = read_launches()
    if not torch.equal(got_of["int16"], got_of["float32"]):
        raise AssertionError(f"phase 13 (c): int16 {got_of['int16'].tolist()} != float32 "
                             f"{got_of['float32'].tolist()}")
    rel = float(((got_of["float32"] - want).abs() / want.abs().clamp(min=1)).max())
    if rel > DIST_RTOL or {k: launches[k] for k in want_launches} != want_launches:
        raise AssertionError(f"phase 13 (c): rel {rel} to single; launches {launches}, "
                             f"predicted {want_launches}")
    out["int16_over_float32"] = out["int16"]["ms_per_coloring"] / out["float32"]["ms_per_coloring"]
    log(f"phase 13 (c): int16 == float32 bitwise, {out['int16_over_float32']:.2f}x its time; "
        f"launches {want_launches} as the rungs predict")
    return out, launches


def compact_nccl(mesh, local):
    """13 (d), inside phase 12's NCCL world of size 1: int16 and int8
    payloads through ``ProcessGroupComm`` as bitcast bytes == what was sent,
    and every mode x fuse x narrow wire on dense and compacted plans ==
    ``LocalMesh`` P = 1."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch.core.distributed import build_distributed_plan, make_count_fn, shard_coloring
    from repro_torch.core.graphs import erdos_renyi
    from repro_torch.core.templates import path_tree, template

    comm = mesh.data
    for dt in (torch.int16, torch.int8):
        x = torch.randint(-100, 100, (1, 37, 3), dtype=dt, device=mesh.device)
        if not torch.equal(comm.all_to_all(x), x) or comm.all_to_all(x).dtype != dt:
            raise AssertionError(f"phase 13 (d): NCCL all_to_all of {dt} changed the payload")
    g = erdos_renyi(97, 5.0, seed=7)
    checked = 0
    for tree in (path_tree(4), template("u5-2")):
        with floors_forced_down():
            comp = build_distributed_plan(g, tree, 1, device=mesh.device, compact=True,
                                          density_threshold=1.0)
        col = np.random.default_rng(4).integers(0, comp.k, g.n).astype(np.int32)
        cols = np.broadcast_to(shard_coloring(comp, col)[None], (2, 1, comp.n_loc_pad))
        for plan in (dc.replace(comp, compaction=None), comp):
            for mode, gf in DIST_MODES:
                for fuse in (False, True):
                    for wire in ("int16", "int8"):
                        kw = dict(mode=mode, group_factor=gf, fuse=fuse, wire_dtype=wire)
                        got = make_count_fn(plan, mesh, **kw)(cols)
                        if got.tolist() != make_count_fn(plan, local, **kw)(cols).tolist():
                            raise AssertionError(f"phase 13 (d) NCCL {tree.name} {kw}: {got}")
                        checked += 1
    log(f"phase 13 (d): NCCL int16 and int8 payloads as bytes; {checked} narrow count calls "
        f"== LocalMesh P=1")
    return {"nccl_narrow_count_calls": checked}


def compact_exact(dev):
    """13 (a): phase 12 (a)'s graphs and trees on LocalMesh P = 4, two
    colorings, alltoall, pipeline g1 and ring (COMPACT_MODES; every mode
    until PR 25, cut for time) x fuse x wire x {dense, compact} == brute
    force on its own rung; storms of compression.saturate and compaction.overflow
    give the same counts on the rungs they force."""
    import dataclasses as dc

    import numpy as np
    from repro_torch.comm import LocalMesh
    from repro_torch.core.brute_force import count_colorful_maps
    from repro_torch.core.distributed import build_distributed_plan, make_count_fn, shard_coloring
    from repro_torch.core.graphs import erdos_renyi, rmat
    from repro_torch.core.templates import path_tree, spider_tree, template
    from repro_torch.testing import faults

    t0 = time.perf_counter()
    mesh = LocalMesh(COMPACT_SHARDS, device=dev)
    calls = 0
    for g in (erdos_renyi(97, 5.0, seed=7), rmat(*DIST_EXACT_RMAT, skew=8, seed=2)):
        for name, tree in (("p4", path_tree(4)), ("sp21", spider_tree([2, 1])),
                           ("u5-2", template("u5-2"))):
            rng = np.random.default_rng(13)
            colorings = [rng.integers(0, tree.n, g.n).astype(np.int32) for _ in range(2)]
            want = [count_colorful_maps(g, tree, c) for c in colorings]
            with floors_forced_down():
                comp = build_distributed_plan(g, tree, COMPACT_SHARDS, device=dev, compact=True,
                                              density_threshold=1.0)
            spec = comp.compaction
            cols = np.stack([shard_coloring(comp, c) for c in colorings])
            # u5-2 (root 0) reads no internal right child: its plan may engage nothing
            engaged = "compact" if spec.enabled else "dense"
            for plan, tag in ((dc.replace(comp, compaction=None), "dense"), (comp, engaged)):
                for mode, gf in COMPACT_MODES:
                    for fuse in (False, True):
                        for wire in WIRES:
                            f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse,
                                              wire_dtype=wire)
                            got = f(cols).tolist()
                            calls += 1
                            if got != want or f.rung != f"{wire} {tag}":
                                raise AssertionError(
                                    f"phase 13 (a) {g.name} {name} {tag} {_dist_label(mode, gf)} "
                                    f"fuse={fuse} {wire}: {got} on {f.rung} != brute force {want}")
            log(f"phase 13 (a) {g.name} {name}: {want}; caps exchange {dict(spec.exchange_caps)} "
                f"ring {dict(spec.shard_caps)} combine {dict(spec.combine_caps)}; every mode x "
                f"fuse x wire x {{dense, compact}} == brute force on its own rung")
            if name != "p4":
                continue
            storms = {}
            for site, wire, mode, at in (("compression.saturate", "int8", "pipeline", (0, 1)),
                                         ("compaction.overflow", "float32", "alltoall", None)):
                f = make_count_fn(comp, mesh, mode=mode, wire_dtype=wire)
                with faults.active(faults.inject(site, at=at)) as fp:
                    got = f(cols).tolist()
                if got != want or not fp.fired:
                    raise AssertionError(f"phase 13 (a) {site} storm: {got} on {f.rung}")
                storms[site] = f.rung
            log(f"phase 13 (a) {g.name} storms: {storms}, counts == brute force")
    log(f"phase 13 (a): {calls} count calls exact in {time.perf_counter() - t0:.1f}s")
    return {"count_calls": calls, "seconds": time.perf_counter() - t0}


def compact_full(name: str, dev, g):
    """13 (b): one sparse row at 2^22 vertices (phase 11's cut), u10-2 on
    LocalMesh P = 4, B = 2: the compacted plan and its dense twin, every
    mode of COMPACT_MODES x fuse x COMPACT_SETTINGS, a warm then a timed
    call; compact == dense and narrow == float32 bitwise within a mode and
    fuse, all within DIST_RTOL of the single-device count; launches as the
    rungs predict.  Returns the launches, the kernel rows and a summary."""
    import dataclasses as dc

    import numpy as np
    import torch
    from repro_torch.comm import LocalMesh
    from repro_torch.configs.subgraph import COUNTING_CONFIGS
    from repro_torch.core import prng
    from repro_torch.core.count_engine import build_counting_plan, colorful_map_count
    from repro_torch.core.distributed import (build_distributed_plan, global_coloring,
                                              make_count_fn, node_exchange_bytes, shard_coloring)
    from repro_torch.core.templates import template

    tag = f"phase 13 (b) {name}"
    row = COUNTING_CONFIGS[name]
    tree = template(row.template)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    comp = build_distributed_plan(g, tree, COMPACT_SHARDS, device=dev, compact=True,
                                  density_threshold=row.density_threshold,
                                  capacity_factor=row.capacity_factor)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    dense = dc.replace(comp, compaction=None)
    spec = comp.compaction
    if not spec.exchange_caps and not spec.shard_caps:
        raise AssertionError(f"{tag}: no exchange or ring capacity engaged: {spec}")
    exchanged = [i for i, nd in enumerate(comp.program.nodes) if nd.kind == "combine"]
    wire_bytes = {f"{mode} {wire}": {str(i): node_exchange_bytes(comp, i, mode, wire)
                                     for i in exchanged}
                  for mode in ("alltoall", "ring") for wire in ("float32", "int16")}
    log(f"{tag}: plan P={COMPACT_SHARDS} (with the probe) {plan_s:.2f}s, r_pad={comp.r_pad} "
        f"n_loc_pad={comp.n_loc_pad}; densities "
        f"{ {i: round(d, 4) for i, d in spec.density.items()} }, exchange caps "
        f"{dict(spec.exchange_caps)}, ring caps {dict(spec.shard_caps)}, combine caps "
        f"{dict(spec.combine_caps)}")
    log(f"{tag}: node_exchange_bytes (dense, compact) a coloring {wire_bytes}")
    keys = prng.split(prng.key(13), COMPACT_BATCH)
    col = torch.stack([global_coloring(k, g.n, comp.k, device=dev) for k in keys])
    cols = np.stack([shard_coloring(comp, c) for c in col.cpu().numpy()])
    single = build_counting_plan(g, tree, device=dev)
    want = colorful_map_count(single, col).cpu()
    del single
    torch.cuda.empty_cache()
    # the kernels at the widest node whose right child ships compacted, on
    # the expanded buffer's shapes (those of the dense exchange)
    caps = spec.exchange_caps or spec.shard_caps
    node = max((comp.combine[i] for i in exchanged if comp.program.nodes[i].right in caps),
               key=lambda t: t.w)
    rows = dist_kernel_rows(comp, dev, (node.a, node.w, node.s, node.j), phase=tag)
    mesh = LocalMesh(COMPACT_SHARDS, device=dev)
    runs, launches_want = {}, {"spmm_edgetile": 0, "color_combine": 0, "fused_count": 0}
    reset_launches()
    for mode, gf in COMPACT_MODES:
        for fuse in (False, True):
            base = None
            for wire, compact in COMPACT_SETTINGS:
                label = (f"{_dist_label(mode, gf)}{' fused' if fuse else ''} {wire} "
                         f"{'compact' if compact else 'dense'}")
                plan = comp if compact else dense
                f = make_count_fn(plan, mesh, mode=mode, group_factor=gf, fuse=fuse,
                                  wire_dtype=wire)
                first = f"{wire} {'compact' if compact else 'dense'}"
                f(cols)
                warm = f.rung
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                got = f(cols)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
                peak = torch.cuda.max_memory_allocated(dev)
                ran = programs_run(first, warm) + programs_run(first, f.rung)
                for k, v in _predicted_launches(plan, f.node_modes, fuse, ran).items():
                    launches_want[k] += v
                if not torch.isfinite(got).all() or got.shape != (COMPACT_BATCH,):
                    raise AssertionError(f"{tag} {label}: bad counts {got}")
                base = got if base is None else base
                rel = float(((got - want).abs() / want.abs().clamp(min=1)).max())
                if not torch.equal(got, base) or rel > DIST_RTOL:
                    raise AssertionError(f"{tag} {label}: {got.tolist()} vs float32 dense "
                                         f"{base.tolist()} (bitwise) and single {want.tolist()} "
                                         f"(rel {rel:.2e})")
                runs[label] = {"ms_per_coloring": dt * 1e3 / COMPACT_BATCH, "peak_bytes": peak,
                               "rung": f.rung, "warm_rung": warm, "programs_run": ran,
                               "max_rel_err": rel}
                log(f"{tag} {label}: {dt * 1e3 / COMPACT_BATCH:.1f} ms/coloring, peak {peak} "
                    f"bytes, ended on {f.rung} (warm {warm}), rel {rel:.2e} to single")
    launches = read_launches()
    if {k: launches[k] for k in launches_want} != launches_want:
        raise AssertionError(f"{tag}: launches {launches}, the rungs predict {launches_want}")
    log(f"{tag}: compact == dense and int16 == float32 bitwise in every mode x fuse, within "
        f"{DIST_RTOL} of single {want.tolist()}; launches {launches_want} as the rungs predict")
    summary = {"plan_s": plan_s, "r_pad": comp.r_pad, "n_loc_pad": comp.n_loc_pad,
               "spec": {"threshold": spec.threshold, "capacity_factor": spec.capacity_factor,
                        "density": dict(spec.density),
                        "exchange_caps": dict(spec.exchange_caps),
                        "shard_caps": dict(spec.shard_caps),
                        "combine_caps": dict(spec.combine_caps)},
               "node_exchange_bytes": wire_bytes, "runs": runs,
               "single_device_counts": want.tolist()}
    del comp, dense, plan, g, mesh, f
    torch.cuda.empty_cache()
    return launches, rows, summary


def compact_launch():
    """13 (d), the launcher: bench-sparse --mode pipeline --shards 4
    --compact --wire-dtype int16 prints the estimates of --wire-dtype
    float32 with no node engaged, and its compaction and routing reports."""
    base = ["--config", "bench-sparse", "--mode", "pipeline", "--shards", "4", "--iters", "16",
            "--batch", "8"]
    narrow = _launch(base + ["--compact", "--wire-dtype", "int16"])
    dense = _launch(base + ["--wire-dtype", "float32", "--density-threshold", "-1"])
    caps = [ln for ln in narrow if ln.startswith("compaction caps")]
    if (not _estimates(narrow) or _estimates(narrow) != _estimates(dense) or not caps
            or "exchange[" not in caps[0]
            or not any(ln.startswith("routing: wire=int16") for ln in narrow)):
        raise AssertionError(f"phase 13 (d) launcher: {narrow} vs {dense}")
    log(f"phase 13 (d) launcher: --compact --wire-dtype int16 == --wire-dtype float32 dense "
        f"({_estimates(narrow)}); {caps[0]}")
    return {"estimates": _estimates(narrow), "caps": caps[0]}


def phase_compact(dev, saturation, narrow_nccl, graphs):
    """Phase 13: (a), (b) on both sparse rows, (c) and the NCCL part of (d)
    from phase 12's run, the launcher.  Returns the path's launches, the
    kernel rows and a summary."""
    t0 = time.perf_counter()
    exact = compact_exact(dev)
    launches, rows, cells = None, None, {}
    for name in SPARSE_GRAPHS:
        cell_launches, cell_rows, cells[name] = compact_full(name, dev, graphs.pop(name))
        launches = cell_launches if launches is None else {
            k: launches[k] + cell_launches[k] for k in launches}
        rows = cell_rows if rows is None else {k: rows[k] + cell_rows[k] for k in rows}
    sat, sat_launches = saturation
    launches = {k: launches[k] + sat_launches[k] for k in launches}
    launcher = compact_launch()
    log(f"phase 13 passed in {time.perf_counter() - t0:.1f}s (without (c) and the NCCL part "
        f"of (d), which ran in phase 12's)")
    return launches, rows, {"exact": exact, "cells": cells, "saturation_u12": sat,
                            "nccl": narrow_nccl, "launcher": launcher}


def flash_bound(q, k, causal: bool, window: int):
    """The larger of q, k, v and o moved once at the HBM rate and the
    allowed pairs' work at its rate: 4 D flops each at the bf16 tensor-core
    rate for bf16, 2 D FMAs each at the CUDA cores' float32 rate for
    float32 (``work.flash_attention``)."""
    from repro_torch.kernels import work

    b, hq, l, d = q.shape
    return bound_ms(work.flash_attention(b, hq, k.shape[1], l, d, q.element_size(), causal,
                                         window))


def sdpa(q, k, v, causal: bool, window: int = 0):
    """PyTorch's fused attention on the same inputs: the library yardstick,
    which the port never calls.  A window goes in as a boolean mask (the
    same function; SDPA then picks a backend that takes a mask)."""
    import torch
    import torch.nn.functional as F

    kw = {"is_causal": causal}
    if window > 0:
        l = q.shape[2]
        pos = torch.arange(l, device=q.device)
        d = pos[:, None] - pos[None, :]
        kw = {"attn_mask": (d < window) & (d >= 0 if causal else d > -window)}
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True, **kw)
    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    return lambda: F.scaled_dot_product_attention(q, kr, vr, **kw)


def flash_check(q, k, v, causal: bool, window: int):
    """The kernel against its plain version; returns the max abs error."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.testing.numerics import bf16_excess

    got = flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = max_abs_err(got.float().flatten(0, 2), want.float().flatten(0, 2))
    if q.dtype == torch.bfloat16:
        excess = bf16_excess(got, want, atol=FLASH_BF16_ATOL)
        ok = excess == 0.0
    else:
        excess = err - FLASH_F32_TOL
        ok = err <= FLASH_F32_TOL
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"flash_attention != plain at {tuple(q.shape)} {q.dtype} "
                             f"causal={causal} window={window}: max_abs_err {err}, beyond the "
                             f"tolerance by {excess}")
    return err


def fp32_geometry():
    """The float32 flash kernel's own geometry (its ``flash_attention_geometry``
    entry) == the host's mirror (``flash_attention.fp32_geometry``) at every
    head dim: tile rows, keys, threads, ring slots, lane rows, shared memory."""
    import ctypes

    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    fn = _build.kernel_fn("flash_attention", "flash_attention_geometry",
                          [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    for d in fa.HEAD_DIMS:
        out = (ctypes.c_int * 6)()
        _build.check(fn(d, out), "flash_attention_geometry")
        if tuple(out) != tuple(fa.fp32_geometry(d)):
            raise AssertionError(f"D={d}: the float32 kernel's geometry {tuple(out)} != the "
                                 f"host's {fa.fp32_geometry(d)}")
    log(f"phase 7: the float32 kernel's geometry == the host's at D {fa.HEAD_DIMS}: "
        f"{[tuple(fa.fp32_geometry(d)) for d in fa.HEAD_DIMS]} (rows, keys, threads, slots, "
        f"lane rows, smem bytes)")


def phase_flash(dev):
    """The flash kernels against their plain version at granite-3-8b's
    prefill launch, timed: bf16 (wgmma) and float32 (CUDA cores); then other
    head dims, masks, lengths and GQA groups, and every launch shape of phase
    16's prefills in bf16."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.testing.numerics import bf16_excess, bf16_ulp

    gen = torch.Generator(device=dev)
    gen.manual_seed(77)

    def qkv(b, hq, hkv, l, d, dtype):
        return [torch.randn(s, generator=gen, device=dev).to(dtype)
                for s in ((b, hq, l, d), (b, hkv, l, d), (b, hkv, l, d))]

    rows = {}
    for dtype, reps in ((torch.bfloat16, 10), (torch.float32, 3)):
        # the prefill's own launch: B=4 prompts, granite's heads, distinct q, k and v
        q, k, v = qkv(LM_BATCH, 32, 8, LM_LEN, 128, dtype)
        err = flash_check(q, k, v, True, 0)
        lib = sdpa(q, k, v, True)
        row = dict(
            shape=f"B={LM_BATCH} Hq=32 Hkv=8 L={LM_LEN} D=128 {str(dtype)[6:]} causal", err=err,
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True), reps=reps),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True), 1),
            library_ms=cuda_ms(lib, reps=reps), bound=flash_bound(q, k, True, 0))
        note = ""
        if dtype == torch.bfloat16:
            # what the yardstick computes: SDPA under the kernel's own gate
            want = ref.flash_attention_ref(q, k, v, causal=True)
            got = lib()
            beyond = ((got.float() - want.float()).abs() - bf16_ulp(want) - FLASH_BF16_ATOL > 0)
            row["library_bf16_excess"] = bf16_excess(got, want, atol=FLASH_BF16_ATOL)
            row["library_share_beyond_gate"] = beyond.float().mean().item()
            note = (f"; sdpa beyond the same gate by {row['library_bf16_excess']:.3g} on "
                    f"{row['library_share_beyond_gate']:.2%} of the outputs")
            del want, got, beyond
        tol = (f"one bf16 step + {FLASH_BF16_ATOL}" if dtype == torch.bfloat16
               else f"{FLASH_F32_TOL}")
        log(f"phase 7 {row['shape']}: kernel {row['ms']:.3f}ms  plain {row['plain_ms']:.3f}ms  "
            f"sdpa {row['library_ms']:.3f}ms  bound {row['bound'][0]:.4f} {row['bound'][1]}; "
            f"max_abs_err {err:.3g} (within {tol}){note}")
        rows[dtype] = row
        del q, k, v, lib
    fp32_geometry()
    for b, hq, hkv, l, d, dtype, causal, window in (
            (1, 32, 8, LM_LEN, 128, torch.bfloat16, True, 0),
            # the float32 kernel at its tiles' edges: L one past a 128-row
            # (64 at D = 256) query tile, GQA groups 1 and 8, D = 64 windowed
            (1, 8, 8, 129, 128, torch.float32, True, 0),
            (1, 10, 1, 65, 256, torch.float32, True, 0),
            (2, 32, 4, 300, 128, torch.float32, True, 0),
            (1, 8, 1, 1000, 64, torch.float32, True, 300),
            (1, 32, 8, 2048, 64, torch.bfloat16, True, 1024),
            (2, 16, 8, 1024, 128, torch.bfloat16, False, 0),
            (2, 8, 2, 1000, 64, torch.float32, False, 300),
            (2, 8, 8, 127, 128, torch.bfloat16, True, 0),  # GQA group 1
            (2, 16, 8, 128, 64, torch.bfloat16, False, 0),  # group 2, one tile
            (1, 32, 8, LM_LEN + 1, 128, torch.bfloat16, True, 0),  # group 4, a key past a tile
            (2, 32, 4, 1, 128, torch.bfloat16, True, 0),  # group 8, one token
            (1, 8, 1, 1000, 64, torch.bfloat16, True, 300),  # group 8, window
            # D = 256 at GQA group 10 (recurrentgemma): ragged, bidirectional
            (1, 10, 1, 1, 256, torch.bfloat16, True, 0),
            (1, 10, 1, 127, 256, torch.bfloat16, True, 0),
            (2, 10, 1, 1000, 256, torch.bfloat16, True, 0),
            (2, 10, 1, 1000, 256, torch.bfloat16, False, 0),
            (2, 10, 1, 1000, 256, torch.float32, False, 0),
            (1, 10, 1, 1000, 256, torch.float32, True, 300)):
        e = flash_check(*qkv(b, hq, hkv, l, d, dtype), causal, window)
        log(f"phase 7 B={b} Hq={hq} Hkv={hkv} L={l} D={d} {dtype} causal={causal} "
            f"window={window}: == plain, max_abs_err {e:.3g}")
    # every self-attention launch of phase 16's prefills, at its own shape
    for b, hq, hkv, l, d, causal, window in lm_row_flash_shapes():
        e = flash_check(*qkv(b, hq, hkv, l, d, torch.bfloat16), causal, window)
        log(f"phase 7 phase-16 launch B={b} Hq={hq} Hkv={hkv} L={l} D={d} bfloat16 "
            f"causal={causal} window={window}: == plain, max_abs_err {e:.3g}")
    # D = 256 at recurrentgemma's prefill launch of its local layers
    d256 = {}
    b, hq, hkv, l, d = RG_FLASH
    for dtype, reps in ((torch.bfloat16, 10), (torch.float32, 3)):
        q, k, v = qkv(b, hq, hkv, l, d, dtype)
        err = flash_check(q, k, v, True, RG_WINDOW)
        lib = sdpa(q, k, v, True, RG_WINDOW)
        row = dict(
            shape=f"B={b} Hq={hq} Hkv={hkv} L={l} D={d} {str(dtype)[6:]} causal "
                  f"window={RG_WINDOW}", err=err,
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=True, window=RG_WINDOW), reps=reps),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=True,
                                                             window=RG_WINDOW), 1),
            library_ms=cuda_ms(lib, reps=reps), bound=flash_bound(q, k, True, RG_WINDOW))
        log(f"phase 7 {row['shape']}: kernel {row['ms']:.3f}ms  plain {row['plain_ms']:.3f}ms  "
            f"sdpa (mask) {row['library_ms']:.3f}ms  bound {row['bound'][0]:.4f} "
            f"{row['bound'][1]}; max_abs_err {err:.3g}")
        d256[dtype] = row
        del q, k, v, lib
    return rows[torch.bfloat16], rows[torch.float32], d256[torch.bfloat16], d256[torch.float32]


def phase_lm(dev, flash_ms: float):
    """granite-3-8b served on the card: prefill, then greedy decode.
    ``flash_ms`` is phase 7's time of one kernel launch at the prefill's shape."""
    import copy

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.transformer import forward

    cfg = get_arch(LM_ARCH)
    model = build_model(cfg, cast_params=True, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)  # what the process holds beside this cell
    params = model.init_fn(gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    log(f"phase 8 {LM_ARCH}: {n_params} parameters ({weight_bytes / 1e9:.2f} GB) drawn in "
        f"{time.perf_counter() - t0:.1f}s")
    gen.manual_seed(1)
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_LEN), generator=gen, device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    logits, caches = model.prefill_fn(params, {"tokens": prompt})
    torch.cuda.synchronize()
    prefill_s, per_prefill = [], []
    for _ in range(LM_TIMED):
        del logits, caches
        before = flash_attention.launches_wgmma
        t0 = time.perf_counter()
        logits, caches = model.prefill_fn(params, {"tokens": prompt})
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        per_prefill.append(flash_attention.launches_wgmma - before)
    tok = logits.argmax(-1, keepdim=True)
    first_tok, steps = tok, []
    t0 = time.perf_counter()
    for i in range(LM_DECODE):
        step, caches = model.decode_fn(params, {"tokens": tok, "pos": LM_LEN + i, "caches": caches})
        steps.append(step)
        tok = step.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / LM_DECODE * 1e3
    first_logits = steps[0]
    if not all(torch.isfinite(x).all() for x in steps):
        raise AssertionError("a bf16 decode step gave logits that are not finite")
    del steps
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated(dev)
    if per_prefill != [cfg.num_layers] * LM_TIMED or launches["flash_attention_fp32"]:
        raise AssertionError(f"bf16 flash launches per prefill {per_prefill}, want "
                             f"{cfg.num_layers} on the wgmma route; path launches {launches}")
    if not torch.isfinite(logits).all() or logits.shape != (LM_BATCH, cfg.padded_vocab):
        raise AssertionError(f"bad prefill logits {tuple(logits.shape)}")
    prefill_ms = min(prefill_s) * 1e3
    log(f"phase 8 prefill B={LM_BATCH} L={LM_LEN}: {[round(t * 1e3, 1) for t in prefill_s]} ms "
        f"({LM_BATCH * LM_LEN / min(prefill_s):.0f} tokens/s); decode {decode_ms:.2f} ms/step "
        f"over {LM_DECODE} steps; peak {peak / 2 ** 30:.2f} GiB; wgmma flash launches per "
        f"prefill {per_prefill}; path launches {launches}")
    split = device_split(lambda: model.prefill_fn(params, {"tokens": prompt}))
    log(f"phase 8 prefill under the profiler: {split}")
    dsplit = device_split(lambda: model.decode_fn(
        params, {"tokens": tok, "pos": LM_LEN + LM_DECODE, "caches": caches}))
    log(f"phase 8 decode step under the profiler: {dsplit}")
    # decode == forward: the first decode step against a forward over L + 1
    # tokens, at the last position.  In bf16 the two paths round at other
    # places (a 4-row GEMM against a 16,388-row one, the plain decode
    # attention against the kernel), and 40 layers of random weights carry
    # those bf16 steps to the logits, so the reference's 2e-2 is held on the
    # same weights in float32 (caches stay bf16, as the reference fixes them).
    # The bf16 path that is served is held to the float32 forward instead:
    # its decode step may stray from it at most LM_BF16_RATIO times as far
    # as the bf16 forward does.
    toks = torch.cat([prompt, first_tok], 1)
    v = cfg.vocab_size  # the pad columns hold -1e30 on both sides
    full, _, _ = forward(params, cfg, toks, mode="train")
    fwd_bf16 = full[:, -1, :v].clone()
    del full, caches, logits, step
    torch.cuda.empty_cache()
    reset_launches()  # the float32 checks below are a path of their own
    params.float()  # the same weights, exactly, in float32 (in place)
    model32 = build_model(cfg, dtype=torch.float32, device=dev)
    _, caches = model32.prefill_fn(params, {"tokens": prompt})
    dec32, caches = model32.decode_fn(params, {"tokens": first_tok, "pos": LM_LEN,
                                               "caches": caches})
    del caches
    full, _, _ = forward(params, cfg, toks, mode="train", dtype=torch.float32)
    fwd32 = full[:, -1].clone()
    del full
    dec_err = (dec32[:, :v] - fwd32[:, :v]).abs().max().item()
    if not torch.allclose(dec32, fwd32, rtol=LM_DECODE_TOL, atol=LM_DECODE_TOL):
        raise AssertionError(f"float32 decode step 0 vs forward over {LM_LEN + 1} tokens: max abs "
                             f"err {dec_err} beyond {LM_DECODE_TOL}")
    fwd32 = fwd32[:, :v]
    bf16_dist = {"decode_vs_forward": (first_logits[:, :v] - fwd_bf16).abs().max().item(),
                 "decode_vs_float32_forward": (first_logits[:, :v] - fwd32).abs().max().item(),
                 "forward_vs_float32_forward": (fwd_bf16 - fwd32).abs().max().item()}
    bf16_ratio = bf16_dist["decode_vs_float32_forward"] / bf16_dist["forward_vs_float32_forward"]
    if not bf16_ratio <= LM_BF16_RATIO:
        raise AssertionError(f"bf16 decode step 0 is {bf16_ratio:.3g}x as far from the float32 "
                             f"forward as the bf16 forward is, beyond {LM_BF16_RATIO}: {bf16_dist}")
    log(f"phase 8: float32 decode step 0 == forward over {LM_LEN + 1} tokens within "
        f"{LM_DECODE_TOL} (max abs err {dec_err:.3g}; logits rms "
        f"{fwd32.pow(2).mean().sqrt().item():.3g}, max {fwd32.abs().max().item():.3g}); bf16 "
        f"decode step 0 {bf16_ratio:.3g}x as far from the float32 forward as the bf16 forward "
        f"(limit {LM_BF16_RATIO}; max abs distances {bf16_dist}); flash {flash_ms:.2f} ms x "
        f"{cfg.num_layers} = {flash_ms * cfg.num_layers / prefill_ms:.1%} of the prefill")
    del params, model, model32
    torch.cuda.empty_cache()
    # the kernel in the model where the CPU can follow: 2 layers, full width, float32
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    card = build_model(cfg2, dtype=torch.float32, device=dev)
    cpu = build_model(cfg2, dtype=torch.float32, device="cpu")
    gen.manual_seed(2)
    p_card = card.init_fn(gen)
    p_cpu = copy.deepcopy(p_card).to("cpu")
    toks = torch.randint(0, cfg.vocab_size, (1, LM_CARD_CPU_LEN), generator=gen, device=dev)
    before = flash_attention.launches_fp32
    got, _ = card.prefill_fn(p_card, {"tokens": toks})
    if flash_attention.launches_fp32 - before != cfg2.num_layers:
        raise AssertionError("the 2-layer prefill did not run the float32 kernel once per layer")
    t0 = time.perf_counter()
    want, _ = cpu.prefill_fn(p_cpu, {"tokens": toks.cpu()})
    cpu_s = time.perf_counter() - t0
    got, want = got.cpu(), want
    rel = (got[:, :v] - want[:, :v]).abs().max().item() / want[:, :v].abs().max().item()
    if not rel <= LM_CARD_CPU_RTOL or not torch.equal(got[:, v:], want[:, v:]):
        raise AssertionError(f"2-layer float32 prefill: card vs CPU relative error {rel}")
    log(f"phase 8: 2-layer full-width float32 prefill (L={LM_CARD_CPU_LEN}) on the card == the "
        f"CPU's within {LM_CARD_CPU_RTOL} (relative error {rel:.3g}; CPU {cpu_s:.1f}s)")
    check_launches = read_launches()
    if check_launches["flash_attention"]:
        raise AssertionError(f"the float32 checks launched the bf16 kernel: {check_launches}")
    del p_card, p_cpu, card, cpu
    torch.cuda.empty_cache()
    return dict(launches=launches, float32_check_launches=check_launches, prefill_ms=prefill_ms,
                prefill_ms_runs=[t * 1e3 for t in prefill_s],
                tokens_per_s=LM_BATCH * LM_LEN / min(prefill_s), decode_ms_per_step=decode_ms,
                peak_bytes=peak, flash_launches_per_prefill=per_prefill[0],
                flash_ms_per_launch=flash_ms,
                flash_share_of_prefill=flash_ms * cfg.num_layers / prefill_ms,
                decode_vs_forward_max_abs_err_float32=dec_err, bf16_max_abs_distances=bf16_dist,
                bf16_decode_over_forward_distance=bf16_ratio,
                card_vs_cpu_rel_err=rel, held_bytes=held,
                prompt_bytes=prompt.numel() * prompt.element_size(),
                n_params=n_params, weight_bytes=weight_bytes, prefill_split=split,
                decode_split=dsplit, mesh_refs=dict(first_tok=first_tok.cpu(),
                                                    fwd32=fwd32.cpu(), dist=bf16_dist))


def device_split(fn, host_ops: bool = True):
    """Device time of the kernels ``fn()`` launches, by kind, from a
    torch.profiler trace, beside the host clock around the call (their
    ratio is the device's busy share).  ``host_ops=False`` traces the device
    alone: only kernels are read either way, and a train step's tens of
    thousands of host ops make the trace take seconds to gather."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] if host_ops else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds, top = {}, []
    for ev in prof.key_averages():
        # kernels only: CPU ops report the device time of what they launch,
        # and "Command Buffer Full" is the runtime waiting for room to launch
        if ev.device_type != DeviceType.CUDA or ev.key == "Command Buffer Full":
            continue
        us = getattr(ev, "self_device_time_total", None)
        ms = (ev.self_cuda_time_total if us is None else us) / 1e3
        name = ev.key.lower()
        kind = ("flash_attention" if "flash_attention_kernel" in name else
                "matmul" if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass", "sm90_"))
                else "optimizer" if "multi_tensor_apply" in name else "other")
        kinds[kind] = kinds.get(kind, 0.0) + ms
        top.append((ev.key, ms, ev.count))
    busy = sum(kinds.values())
    top = sorted(top, key=lambda x: -x[1])[:6]
    return {"device_ms_by_kind": kinds, "device_busy_ms": busy, "wall_ms": wall_ms,
            "busy_share": busy / wall_ms if wall_ms else None,
            "top_kernels": [[n[:80], ms, c] for n, ms, c in top]}


# ---------------------------------------------------------------------------
# phase 14: the counting service
# ---------------------------------------------------------------------------

#: the request script: bench-service's (k = 7, batch 8, tenants alice, bob,
#: carol, templates u3-1, u5-2, u7-2, repeated twice)
SERVE_WORKLOAD = "bench-service"
#: (e): the faults run at bench-small's size
SERVE_FAULT_CONFIG = "bench-small"
SERVE_SHARDS = 4  # (f): LocalMesh ranks sharing the card
SERVE_DIST_RTOL = 1e-5  # (f): distributed vs the single-device plan, same colorings
SERVE_MEM_SLACK = 1 << 20  # (d): bytes
SERVE_SLOW = (1.0, 3.0)  # (e): supervisor timeout and the slow pass's sleep, seconds


def serve_instrument(svc, want=None):
    """Time ``svc``'s steps, dispatches and plan builds on the host clock,
    and (single backend) add to ``want`` the launches each dispatch's
    family program predicts (a tree node one SpMM and one combine, or one
    fused launch).  The service, like the reference's, keeps no per-call
    times of its own, so this wraps its ``step``, ``_call`` and the
    counter's ``_family``; :func:`serve_instrument_check` fails the phase
    if the wrappers did not see every dispatch and build."""
    rec = {"step_s": [], "call_s": [], "build_s": []}
    step, call, family = svc.step, svc._call, svc._counter._family

    def timed_step():
        t0 = time.perf_counter()
        try:
            return step()
        finally:
            rec["step_s"].append(time.perf_counter() - t0)

    def timed_call(entry, key, batch, call_index):
        t0 = time.perf_counter()
        out = call(entry, key, batch, call_index=call_index)
        rec["call_s"].append(time.perf_counter() - t0)
        if want is not None:
            plan = svc._counter._families[entry["trees"]]["plan"]
            kinds = [nd.kind for nd in plan.dag.nodes]
            if set(kinds) != {"leaf", "combine"}:
                raise AssertionError(f"phase 14: node kinds {set(kinds)} in {entry['trees']}")
            for name in (("fused_count",) if plan.fuse else ("spmm_edgetile", "color_combine")):
                want[name] += kinds.count("combine")
        return out

    def timed_family(trees):
        t0 = time.perf_counter()
        try:
            return family(trees)
        finally:
            rec["build_s"].append(time.perf_counter() - t0)

    svc.step, svc._call, svc._counter._family = timed_step, timed_call, timed_family
    return rec


def serve_instrument_check(tag, rec, stats):
    """Every dispatch (pass and backfill calls) and every plan-cache miss
    went through the wrappers of :func:`serve_instrument`."""
    calls = stats["pass_calls"] + stats["backfill_calls"]
    misses = stats["plan_cache"]["misses"]
    if (len(rec["call_s"]) != calls or len(rec["build_s"]) != misses
            or len(rec["step_s"]) < calls or not calls):
        raise AssertionError(f"{tag}: the timers saw {len(rec['call_s'])} dispatches, "
                             f"{len(rec['build_s'])} builds and {len(rec['step_s'])} steps; "
                             f"the service counts {calls} dispatches and {misses} misses")


def serve_union(wl) -> tuple:
    """Every template of the workload's script, in order of first use."""
    return tuple(dict.fromkeys(n for _, names, _ in wl.requests for n in names))


def serve_kernel_rows(g, dev, wl):
    """Each kernel against its plain version at every node shape of the
    script's union family plan (u3-1/u5-2/u7-2 at k = 7, batch 8): the
    shapes the service's passes give the kernels.  Returns the plan (the
    single-device reference of (f)) and the rows."""
    from repro_torch.core.count_engine import build_multi_counting_plan

    t0 = time.perf_counter()
    plan = build_multi_counting_plan(g, serve_union(wl), n_colors=wl.k, device=dev)
    log(f"phase 14 union plan {serve_union(wl)} k={plan.k}: {len(plan.dag.nodes)} DAG nodes, "
        f"{len(plan.dag.internal_nodes())} internal; plan in {time.perf_counter() - t0:.1f}s")
    return plan, dag_kernel_rows(plan, wl.batch, "phase 14")


def serve_shapes_covered(tag, svc, union_plan):
    """Every node shape of every family plan ``svc`` built is one the
    kernel rows of the union plan hold."""
    held = set(node_shapes(union_plan, union_plan.dag))
    for trees, st in svc._counter._families.items():
        plan = st["plan"]
        got = set(node_shapes(plan, plan.dag))
        if plan.n_pad != union_plan.n_pad or not got <= held:
            raise AssertionError(f"{tag}: {[t.name for t in trees]} has node shapes "
                                 f"{sorted(got - held)} beyond the kernel rows' {sorted(held)}")


def serve_submit_script(svc, wl, tenant=None):
    """Submit the workload's script (one tenant's part of it with
    ``tenant``); returns ``[((tenant, i), ticket)]``, ``i`` the request's
    place among its tenant's."""
    seen, out = {}, []
    for _ in range(wl.repeats):
        for name, templates, kw in wl.requests:
            i = seen[name] = seen.get(name, -1) + 1
            if tenant is None or name == tenant:
                out.append(((name, i), svc.submit(name, templates, **kw)))
    return out


def serve_solo(counters, g, t, backend="single", **opts):
    """The port's solo estimate for ticket ``t``'s request (memoized on
    ``counters``): ``Counter.estimate`` for one template, ``estimate_many``
    for a family, at the service's k and batch and the request's key and
    budget."""
    from repro_torch.api import Counter

    req = t._request
    names = tuple(t.templates)
    memo = (names, req.n_iter, req.target_rsd, req.key_fp, backend)
    if memo not in counters:
        kw = dict(key=req.key, batch=req.batch, delta=req.delta, target_rsd=req.target_rsd)
        ck = (names[0], len(names) == 1, backend)
        if ck not in counters:
            counters[ck] = Counter.from_graph(g, names[0], backend=backend,
                                              n_colors=t._service.k, **opts)
        c = counters[ck]
        counters[memo] = (c.estimate(req.n_iter, **kw) if len(names) == 1
                          else c.estimate_many(names, req.n_iter, **kw))
    return counters[memo]


def serve_same(a, b) -> bool:
    """Two results of one request agree bitwise: niter, samples, estimate(s)."""
    import numpy as np

    if a.niter != b.niter or not np.array_equal(a.samples, b.samples):
        return False
    if hasattr(a, "estimates"):
        return np.array_equal(a.estimates, b.estimates)
    return a.estimate == b.estimate


def serve_check_solo(tag, tickets, counters, g, **kw):
    for key, t in tickets:
        if t.status != "done":
            raise AssertionError(f"{tag} {key}: {t.status} ({t.error})")
        solo = serve_solo(counters, g, t, **kw)
        if not serve_same(t.result(), solo):
            raise AssertionError(f"{tag} {key} {t.templates}: {t.result().samples[:4]} != solo "
                                 f"{solo.samples[:4]} (niter {t.result().niter}, {solo.niter})")


def serve_stats(svc) -> dict:
    s = svc.stats()
    return {k: s.get(k, 0) for k in ("pass_calls", "request_calls", "backfill_calls",
                                     "history_rides", "quarantined", "completed")} | {
        "coalescing_factor": s["coalescing_factor"], "plan_cache": s["cache"],
        "memo": s["results"]}


def serve_sync(g, dev, wl, card, union_plan):
    """(a): the script on a synchronous service, unfused then fused, each
    done ticket == the solo estimate bitwise (fused == unfused), launches as
    the dispatches' family programs predict, every plan's node shapes among
    ``union_plan``'s; timings of the unfused run; then the unfused run once
    more under the profiler (the busy share)."""
    import numpy as np
    import torch
    from repro_torch.serve import CountingService, ServiceConfig

    runs, want = {}, {"spmm_edgetile": 0, "color_combine": 0, "fused_count": 0}
    reset_launches()
    for fuse in (False, True):
        svc = CountingService(g, n_colors=wl.k, backend="single",
                              plan_opts={"device": dev, "fuse": fuse},
                              config=ServiceConfig(batch=wl.batch))
        rec = serve_instrument(svc, want)
        t0 = time.perf_counter()
        tickets = serve_submit_script(svc, wl)
        svc.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[fuse] = (svc, tickets, rec, wall)
    launches = read_launches()
    got = {k: launches[k] for k in want}
    if got != want or any(v <= 0 for v in got.values()):
        raise AssertionError(f"phase 14 (a): launches {launches}, the dispatches predict {want}")
    counters = {}
    serve_check_solo("phase 14 (a) unfused", runs[False][1], counters, g, device=dev)
    for (key, a), (_, b) in zip(runs[False][1], runs[True][1]):
        if not serve_same(a.result(), b.result()):
            raise AssertionError(f"phase 14 (a) {key}: fused != unfused")
    for fuse, (s, _, r, _) in runs.items():
        serve_instrument_check(f"phase 14 (a) fuse={fuse}", r, serve_stats(s))
        serve_shapes_covered(f"phase 14 (a) fuse={fuse}", s, union_plan)
    svc, tickets, rec, wall = runs[False]
    stats = serve_stats(svc)
    if stats["coalescing_factor"] <= 1.0:
        raise AssertionError(f"phase 14 (a): no coalescing {stats}")
    misses = stats["plan_cache"]["misses"]
    lat = sorted(t.latency_s for _, t in tickets)

    def host_ms(r):  # step less dispatch and plan builds, a dispatch
        return (sum(r["step_s"]) - sum(r["call_s"]) - sum(r["build_s"])) / len(r["call_s"]) * 1e3

    timing = {
        "wall_s": wall, "dispatches": len(rec["call_s"]),
        "plan_build_s_per_miss": sum(rec["build_s"]) / misses,
        "ms_per_pass_call_median": float(np.median(rec["call_s"])) * 1e3,
        "ms_per_pass_call_ewma": svc._call_ewma_s * 1e3,
        "latency_p50_s": float(np.median(lat)), "latency_max_s": lat[-1],
        "host_overhead_ms_per_call": host_ms(rec),
        "fused_host_overhead_ms_per_call": host_ms(runs[True][2]),
        "fused_wall_s": runs[True][3],
        "fused_ms_per_pass_call_median": float(np.median(runs[True][2]["call_s"])) * 1e3,
    }
    log(f"phase 14 (a) {wl.name} (k={wl.k}, batch {wl.batch}, {len(tickets)} requests) on the "
        f"main graph: every done ticket == its solo estimate bitwise, fused == unfused; "
        f"launches {got} as the {timing['dispatches']} dispatches' family programs predict")
    log(f"phase 14 (a) stats: {stats}")
    log(f"phase 14 (a) [{card}] unfused run {wall:.2f}s (fused {runs[True][3]:.2f}s): plan build "
        f"{timing['plan_build_s_per_miss']:.3f} s per cache miss ({misses} misses); "
        f"{timing['ms_per_pass_call_median']:.2f} ms per pass call (median; EWMA "
        f"{timing['ms_per_pass_call_ewma']:.2f}; fused median "
        f"{timing['fused_ms_per_pass_call_median']:.2f}); request latency p50 "
        f"{timing['latency_p50_s']:.3f} s, max {timing['latency_max_s']:.3f} s; host overhead "
        f"{timing['host_overhead_ms_per_call']:.3f} ms per pass call (step less dispatch and "
        f"plan builds; the fused run, second in the process, "
        f"{timing['fused_host_overhead_ms_per_call']:.3f}); coalescing "
        f"x{stats['coalescing_factor']:.2f}, plan-cache hit rate "
        f"{stats['plan_cache']['hit_rate']:.2f}")
    results = {key: t.result() for key, t in tickets}
    runs.clear()
    del svc, tickets

    def rerun():
        s = CountingService(g, n_colors=wl.k, backend="single", plan_opts={"device": dev},
                            config=ServiceConfig(batch=wl.batch))
        serve_submit_script(s, wl)
        s.run_until_idle()

    split = device_split(rerun)
    log(f"phase 14 (a) [{card}] unfused run under the profiler: busy {split['device_busy_ms']:.1f} "
        f"of {split['wall_ms']:.1f} ms ({split['busy_share']:.1%}); top {split['top_kernels'][:4]}")
    timing["profiled"] = split
    return launches, results, counters, {"stats": stats, "timing": timing}


def serve_threaded(g, dev, wl, results):
    """(b): the driver thread; three client threads, one per tenant, submit
    their part of the script at once; every result == (a)'s bitwise."""
    import threading

    from repro_torch.serve import CountingService, ServiceConfig

    svc = CountingService(g, n_colors=wl.k, backend="single", plan_opts={"device": dev},
                          config=ServiceConfig(batch=wl.batch)).start()
    tenants = sorted({name for name, _, _ in wl.requests})
    barrier, out, errors = threading.Barrier(len(tenants)), {}, []

    def client(name):
        try:
            barrier.wait()
            out.update(serve_submit_script(svc, wl, tenant=name))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(n,)) for n in tenants]
    t0 = time.perf_counter()
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(300)
        if errors:
            raise errors[0]
        if not all(t.wait(300) for t in out.values()) or not svc.join_idle(300):
            raise AssertionError("phase 14 (b): the driver did not drain")
    finally:
        svc.stop()
    wall = time.perf_counter() - t0
    for key, t in out.items():
        if t.status != "done" or not serve_same(t.result(), results[key]):
            raise AssertionError(f"phase 14 (b) {key}: {t.status} differs from (a)")
    if svc.driver_errors:
        raise AssertionError(f"phase 14 (b): driver errors {svc.driver_errors}")
    stats = serve_stats(svc)
    log(f"phase 14 (b): {len(out)} requests from {len(tenants)} client threads on the driver "
        f"thread in {wall:.2f}s == (a) bitwise; stats {stats}")
    return {"wall_s": wall, "stats": stats}


class _Clock:
    """A virtual clock for deadlines: ``sleep`` advances it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += s


def serve_cancel(g, dev, wl, counters):
    """(c): cancel one request mid-stream and let one deadline expire (a
    virtual clock); the co-riders == their solo results bitwise, and the
    cancelled ticket's state, checkpointed, resumes through the solo
    estimate_many to the uninterrupted solo result."""
    from repro_torch.api import Counter
    from repro_torch.core import prng
    from repro_torch.serve import CountingService, ServiceConfig

    clk = _Clock()
    svc = CountingService(g, n_colors=wl.k, backend="single", plan_opts={"device": dev},
                          config=ServiceConfig(batch=wl.batch), clock=clk, sleep=clk.sleep)
    (_, fam, fkw), (_, fam_b, bkw), (_, one, okw), _, (_, one2, o2kw) = wl.requests
    cancelled = svc.submit("alice", fam, **fkw)
    expired = svc.submit("bob", fam_b, **bkw, timeout_s=10.0)
    riders = [(("carol", 0), svc.submit("carol", one, **okw)),
              (("carol", 1), svc.submit("carol", one2, **o2kw))]
    for _ in range(3):
        svc.step()
    if not cancelled.cancel():
        raise AssertionError("phase 14 (c): cancel did not take effect")
    clk.t += 11.0
    svc.run_until_idle()
    if cancelled.status != "cancelled" or expired.status != "deadline_exceeded":
        raise AssertionError(f"phase 14 (c): {cancelled.status}, {expired.status}")
    serve_check_solo("phase 14 (c) co-rider", riders, counters, g, device=dev)
    st = cancelled.state()
    if not (0 < st.cursor < cancelled._request.n_calls) or st.status != "cancelled":
        raise AssertionError(f"phase 14 (c): cancelled state at cursor {st.cursor} ({st.status})")
    with tempfile.TemporaryDirectory(prefix=".smoke_tmp", dir=ROOT) as tmp:
        cancelled.checkpoint(tmp)
        c = Counter.from_graph(g, fam[0], n_colors=wl.k, device=dev)
        resumed = c.estimate_many(fam, fkw["n_iter"], key=prng.key(0), batch=wl.batch,
                                  resume=tmp)
    full = serve_solo(counters, g, cancelled, device=dev)
    if resumed.resumed_from != st.cursor * wl.batch or not serve_same(resumed, full):
        raise AssertionError(f"phase 14 (c): resumed {resumed.resumed_from} iterations, "
                             f"samples {resumed.samples[:2]} vs {full.samples[:2]}")
    log(f"phase 14 (c): cancelled at call {st.cursor} of {cancelled._request.n_calls} and "
        f"resumed through estimate_many(resume=...) == the uninterrupted solo result bitwise; "
        f"{expired} expired after {expired._request.cursor} calls; co-riders == solo")
    return {"cancel_cursor": st.cursor, "expired_cursor": expired._request.cursor}


def serve_evict(g, dev, wl, card):
    """(d): plan_cache_capacity=1; families A, B, A (two evictions): the
    memory after them == with A's plan alone, and after the service goes,
    == before the first build, each within SERVE_MEM_SLACK."""
    import gc

    import torch
    from repro_torch.serve import CountingService, ServiceConfig

    fam_a, fam_b = wl.requests[0][1], wl.requests[1][1]
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated(dev)
    svc = CountingService(g, n_colors=wl.k, backend="single", plan_opts={"device": dev},
                          config=ServiceConfig(batch=wl.batch, plan_cache_capacity=1,
                                               result_cache_capacity=0))
    mem = []
    for fam in (fam_a, fam_b, fam_a):
        svc.submit("alice", fam, n_iter=wl.batch)
        svc.run_until_idle()
        gc.collect()
        mem.append(torch.cuda.memory_allocated(dev))
    cache = svc.stats()["cache"]
    done = all(t.status == "done" for t in svc.completed)
    del svc
    gc.collect()
    torch.cuda.empty_cache()
    after = torch.cuda.memory_allocated(dev)
    if (cache["evictions"] != 2 or not done or abs(mem[2] - mem[0]) > SERVE_MEM_SLACK
            or abs(after - before) > SERVE_MEM_SLACK):
        raise AssertionError(f"phase 14 (d): cache {cache}, memory before {before}, after each "
                             f"family {mem}, after the service {after}")
    log(f"phase 14 (d) [{card}]: {cache['evictions']} evictions; allocated {before} bytes before "
        f"the first build, {mem} after A, B, A (A's plan {mem[0] - before} bytes), {after} after "
        f"the service went")
    return {"before": before, "after_each": mem, "after": after, "plan_bytes": mem[0] - before}


def serve_faults(dev, wl):
    """(e) at bench-small's size on the card: service.pass_poison
    quarantines one call of one pass and the request on another pass is
    untouched; service.step_crash is recorded and the driver goes on;
    service.slow_pass under timeout_s retries at the same key, bitwise."""
    import numpy as np
    import torch
    from repro_torch.configs.subgraph import COUNTING_CONFIGS
    from repro_torch.core import prng
    from repro_torch.serve import CountingService, ServiceConfig
    from repro_torch.testing import faults

    g = COUNTING_CONFIGS[SERVE_FAULT_CONFIG].synthesize()
    counters = {}

    def svc_of(**kw):
        return CountingService(g, n_colors=wl.k, backend="single", plan_opts={"device": dev},
                               config=ServiceConfig(batch=wl.batch, **kw))

    def solo_rows(t, drop=()):
        s = serve_solo(counters, g, t, device=dev).samples
        b = wl.batch
        return [s[i * b:(i + 1) * b] for i in range(len(s) // b) if i not in drop]

    svc = svc_of()
    ta = svc.submit("alice", ("u3-1", "u5-2"), n_iter=2 * wl.batch)
    tc = svc.submit("carol", ("u3-1",), n_iter=2 * wl.batch)
    tb = svc.submit("bob", ("u5-2",), n_iter=2 * wl.batch, key=prng.key(5))
    with faults.active(faults.inject("service.pass_poison", at=(0,))) as plan:
        svc.run_until_idle()
    if plan.fired != [("service.pass_poison", 0)] or svc.stats().get("quarantined") != 1:
        raise AssertionError(f"phase 14 (e) pass_poison: fired {plan.fired}, {svc.stats()}")
    for t in (ta, tc):
        r = t.result()
        if [q.call_index for q in r.quarantined] != [0] or not np.array_equal(
                r.samples, np.concatenate(solo_rows(t, drop={0}))):
            raise AssertionError(f"phase 14 (e) pass_poison {t}: {r.quarantined}")
    serve_check_solo("phase 14 (e) other pass", [("bob", tb)], counters, g, device=dev)

    svc = svc_of().start()
    try:
        with faults.active(faults.inject("service.step_crash", at=(0,))) as plan:
            t = svc.submit("alice", ("u3-1", "u5-2"), n_iter=2 * wl.batch)
            if not t.wait(300) or not plan.fired:
                raise AssertionError("phase 14 (e) step_crash: the request did not finish")
    finally:
        svc.stop()
    if not any("InjectedFault" in e for e in svc.driver_errors):
        raise AssertionError(f"phase 14 (e) step_crash: driver errors {svc.driver_errors}")
    serve_check_solo("phase 14 (e) step_crash", [("alice", t)], counters, g, device=dev)

    timeout, slow = SERVE_SLOW
    svc = svc_of(timeout_s=timeout, max_retries=1)
    t = svc.submit("alice", ("u3-1", "u5-2"), n_iter=2 * wl.batch)
    t0 = time.perf_counter()
    with faults.active(faults.inject("service.slow_pass", at=(0,), payload=slow)) as plan:
        svc.run_until_idle()
    dt = time.perf_counter() - t0
    if ("service.slow_pass", 0) not in plan.fired or t.result().quarantined:
        raise AssertionError(f"phase 14 (e) slow_pass: fired {plan.fired}, {t.result()}")
    serve_check_solo("phase 14 (e) slow_pass", [("alice", t)], counters, g, device=dev)
    # the timed-out attempt's thread sleeps on, then runs its pass: let it
    # end before the next check measures the card
    time.sleep(max(0.0, slow - dt) + 1.0)
    torch.cuda.synchronize()
    log(f"phase 14 (e) {SERVE_FAULT_CONFIG} (V={g.n}): pass_poison quarantined call 0 of one "
        f"pass (its riders == solo less that call, the other pass == solo); step_crash recorded "
        f"and the driver went on; slow_pass past a {timeout}s timeout retried at the same key "
        f"== solo bitwise in {dt:.2f}s")
    return {"graph": SERVE_FAULT_CONFIG, "slow_pass_s": dt}


def serve_distributed(g, dev, wl, card, union_plan):
    """(f): the script on the distributed backend, LocalMesh P = 4 on the
    card: every ticket == the solo distributed estimate bitwise, and every
    call of every ticket within SERVE_DIST_RTOL of ``union_plan`` (the
    single-device family plan of all the script's templates) on the same
    colorings: the keyed backend draws each iteration's coloring from its
    own split key, so (a)'s samples are of other colorings."""
    import numpy as np
    import torch
    from repro_torch.core import prng
    from repro_torch.core.count_engine import colorful_map_count_many
    from repro_torch.core.distributed import global_coloring
    from repro_torch.core.estimator import call_key
    from repro_torch.serve import CountingService, ServiceConfig

    opts = {"num_shards": SERVE_SHARDS, "device": dev}
    t0 = time.perf_counter()
    svc = CountingService(g, n_colors=wl.k, backend="distributed", plan_opts=opts,
                          config=ServiceConfig(batch=wl.batch))
    rec = serve_instrument(svc)
    tickets = serve_submit_script(svc, wl)
    svc.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counters = {}
    serve_check_solo("phase 14 (f)", tickets, counters, g, backend="distributed", **opts)
    names = [t.name for t in union_plan.templates]
    scales = np.asarray(union_plan.scales)
    single, rel, calls = {}, 0.0, 0
    for key, t in tickets:
        req, got, b = t._request, t.result().samples, wl.batch
        cols = [names.index(n) for n in t.templates]
        for c in range(len(got) // b):
            if (req.key_fp, c) not in single:  # one call's colorings, on the union plan
                colorings = torch.stack([global_coloring(k, g.n, wl.k, device=dev)
                                         for k in prng.split(call_key(req.key, c), b)])
                single[req.key_fp, c] = (colorful_map_count_many(union_plan, colorings)
                                         .cpu().numpy() * scales)
            want = single[req.key_fp, c][:, cols].reshape(got[c * b:(c + 1) * b].shape)
            rel = max(rel, float(np.max(np.abs(got[c * b:(c + 1) * b] - want) / np.abs(want))))
            calls += 1
    if rel > SERVE_DIST_RTOL or not calls:
        raise AssertionError(f"phase 14 (f): rel {rel} to the single-device plan over {calls} "
                             f"calls")
    stats = serve_stats(svc)
    serve_instrument_check("phase 14 (f)", rec, stats)
    timing = {"wall_s": wall, "dispatches": len(rec["call_s"]),
              "plan_build_s_per_miss": sum(rec["build_s"]) / stats["plan_cache"]["misses"],
              "ms_per_pass_call_median": float(np.median(rec["call_s"])) * 1e3}
    log(f"phase 14 (f) [{card}] distributed, LocalMesh P={SERVE_SHARDS} on the main graph: "
        f"every ticket == its solo distributed estimate bitwise; all {calls} calls of the "
        f"{len(tickets)} tickets ({len(single)} batches of colorings) within rel {rel:.2e} "
        f"of the single-device plan on the same colorings; run {wall:.2f}s, plan build "
        f"{timing['plan_build_s_per_miss']:.2f} s per miss, "
        f"{timing['ms_per_pass_call_median']:.1f} "
        f"ms per pass call (median), stats {stats}")
    return {"graph": "main", "shards": SERVE_SHARDS, "rel_to_single": rel,
            "calls_checked": calls, "stats": stats, "timing": timing}


def _serve_launch(argv):
    from repro_torch.launch.serve import main as serve_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        serve_main(argv)
    out = buf.getvalue()
    log("".join(f"  {line}\n" for line in out.splitlines()).rstrip())
    return out.splitlines()


def serve_launch():
    """(g): the launcher: bench-service synchronous and --threaded print
    identical estimates; smoke-service on the distributed backend runs."""
    def estimates(lines):
        return [ln.split("latency=")[0] for ln in lines if ln.startswith("  Ticket(")]

    sync = _serve_launch(["--workload", "bench-service"])
    threaded = _serve_launch(["--workload", "bench-service", "--threaded"])
    if not estimates(sync) or estimates(sync) != estimates(threaded):
        raise AssertionError(f"phase 14 (g): --threaded printed {threaded}, not {sync}")
    dist = _serve_launch(["--workload", "smoke-service", "--backend", "distributed"])
    if not any(ln.startswith("served 3 (failed 0") for ln in dist):
        raise AssertionError(f"phase 14 (g): smoke-service --backend distributed: {dist}")
    log("phase 14 (g): the launcher's bench-service and --threaded print identical estimates; "
        "smoke-service --backend distributed serves its 3 requests")


def phase_serve(g, dev):
    """Phase 14: the counting service on the main graph (see the module
    docstring); returns the path's launches, the kernel rows at its shapes
    and what the kernels line reports."""
    import torch
    from repro_torch.configs.subgraph import SERVICE_WORKLOADS

    wl = SERVICE_WORKLOADS[SERVE_WORKLOAD]
    card = card_line()
    t0 = time.perf_counter()
    union_plan, rows = serve_kernel_rows(g, dev, wl)
    launches, results, counters, sync = serve_sync(g, dev, wl, card, union_plan)
    threaded = serve_threaded(g, dev, wl, results)
    cancel = serve_cancel(g, dev, wl, counters)
    counters.clear()
    torch.cuda.empty_cache()
    evict = serve_evict(g, dev, wl, card)
    faults_ = serve_faults(dev, wl)
    dist = serve_distributed(g, dev, wl, card, union_plan)
    del union_plan
    torch.cuda.empty_cache()
    serve_launch()
    dt = time.perf_counter() - t0
    log(f"phase 14 passed in {dt:.1f}s")
    return launches, rows, {"workload": wl.name, "templates": serve_union(wl), "k": wl.k,
                            "batch": wl.batch, "graph": "main", "seconds": dt, "sync": sync,
                            "threaded": threaded, "cancel": cancel, "evict": evict,
                            "faults": faults_, "distributed": dist}


# ---------------------------------------------------------------------------
# phase 15: the counting dry-run and the roofline
# ---------------------------------------------------------------------------

DRYRUN_PROCS = 8  # dry-run CLI processes at once (the host's cores)
DRYRUN_MODES = ("alltoall", "pipeline", "ring")  # (a): rmat500-u12-2 side by side
#: (a): the rows also dry-run at the 2 x 16 x 16 mesh (every row until PR 25,
#: cut for time to one: 16 records, two waves of DRYRUN_PROCS;
#: tests/test_torch_dryrun.py runs them all on the CPU)
DRYRUN_MULTI_POD = ("friendster-u12-1",)
MODEL_RTOL_WS1 = 0.05  # (b): predicted rank growth vs NCCL at world size 1
MODEL_RTOL_LOCAL = 0.15  # (c): each end of the predicted peak's interval vs LocalMesh P = 4
MODEL_RTOL_RATIO = 0.10  # (c): each end of the alltoall / pipeline ratio's interval


def dryrun_rows():
    """(a): the dry-run CLI for every COUNTING_CONFIGS row at its production
    mesh (DRYRUN_MULTI_POD's multi-pod too), and rmat500-u12-2 at each mode, in
    processes that see no card (the dry-run touches none); the roofline of
    each record against this card's memory."""
    import os
    from repro_torch.configs.subgraph import COUNTING_CONFIGS
    from repro_torch.roofline.analysis import analyze_record, device_memory_bytes

    jobs = [(row, mp, None) for row in sorted(COUNTING_CONFIGS)
            for mp in ((False, True) if row in DRYRUN_MULTI_POD else (False,))]
    jobs += [("rmat500-u12-2", False, m) for m in DRYRUN_MODES
             if m != COUNTING_CONFIGS["rmat500-u12-2"].mode]
    # one thread a process: meta ops compute nothing, and eight processes share the cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    running, records = {}, {}
    pending = list(jobs)
    t0 = time.perf_counter()
    while pending or running:
        while pending and len(running) < DRYRUN_PROCS:
            row, mp, mode = job = pending.pop(0)
            argv = [sys.executable, "-m", "repro_torch.launch.dryrun", "--counting", row]
            argv += ["--multi-pod"] * mp + (["--counting-mode", mode] if mode else [])
            running[job] = subprocess.Popen(argv, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)
        job, proc = next(iter(running.items()))
        out, err = proc.communicate(timeout=600)
        del running[job]
        lines = out.strip().splitlines()
        rec = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else None
        if proc.returncode != 0 or rec is None or rec["status"] != "ok":
            raise AssertionError(f"phase 15 (a) dry-run {job}: rc {proc.returncode}, "
                                 f"{(rec or {}).get('error')}\n{err[-2000:]}")
        records[job] = rec
    hbm = device_memory_bytes()
    summary = {}
    for (row, mp, mode), rec in sorted(records.items(), key=lambda kv: str(kv[0])):
        t = analyze_record(rec, hbm_bytes=hbm)
        mem = rec["memory"]
        key = f"{row} {rec['mesh']} {rec['mode']}"
        summary[key] = {"argument_bytes": mem["argument_bytes"], "temp_bytes": mem["temp_bytes"],
                        "output_bytes": mem["output_bytes"], "fits": t.fits,
                        "dominant": t.dominant, "compute_s": t.compute_s,
                        "memory_s": t.memory_s, "collective_s": t.collective_s,
                        "collective_bytes": sum(v for k, v in rec["collectives"].items()
                                                if k != "ops"),
                        "launches": rec["launches"], "analysis_s": rec["analysis_s"]}
        log(f"phase 15 (a) {key}: rank arguments {mem['argument_bytes']} B, temp "
            f"{mem['temp_bytes']} B, fits {t.fits} ({hbm:.4g} B), dominant {t.dominant} "
            f"(compute {t.compute_s:.4g} s, memory {t.memory_s:.4g} s, collective "
            f"{t.collective_s:.4g} s)")
    side = {m: summary[f"rmat500-u12-2 16x16 {m}"] for m in DRYRUN_MODES}
    log("phase 15 (a) rmat500-u12-2 at 16x16, alltoall / pipeline / ring: rank bytes "
        + " / ".join(str(side[m]["argument_bytes"] + side[m]["temp_bytes"]
                         + side[m]["output_bytes"]) for m in DRYRUN_MODES)
        + ", collective bytes " + " / ".join(f"{side[m]['collective_bytes']:.4g}"
                                               for m in DRYRUN_MODES)
        + f"; {len(records)} records in {time.perf_counter() - t0:.1f}s")
    return {"records": summary, "rmat500_u12_2_modes": side, "hbm_bytes": hbm}


def dryrun_world_size_1(metas, growth):
    """(b): the model of each phase 12 (c) NCCL call at world size 1 (the
    plan moved to meta, B = 2): temporaries, output and the colorings it
    copies in, against the call's max_memory_allocated growth."""
    from repro_torch.comm import AbstractMesh
    from repro_torch.launch.dryrun import measure_rank

    out, worst = [], 0.0
    for g in growth:
        mem = measure_rank(metas[(g["graph"], g["tree"])], AbstractMesh(1), batch=2,
                           mode=g["mode"], group_factor=g["group_factor"],
                           fuse=g["fuse"])["memory"]
        pred = mem["temp_bytes"] + mem["output_bytes"] + mem["colorings_bytes"]
        rel = abs(pred - g["growth_bytes"]) / max(g["growth_bytes"], 1)
        worst = max(worst, rel)
        out.append(dict(g, predicted_bytes=pred, rel_err=rel))
        log(f"phase 15 (b) {g['graph']} {g['tree']} {g['mode']}-g{g['group_factor']}"
            f"{' fused' if g['fuse'] else ''}: predicted growth {pred} B, measured "
            f"{g['growth_bytes']} B (rel {rel:.4f})")
    missed = [c for c in out if c["rel_err"] > MODEL_RTOL_WS1]
    if missed:
        raise AssertionError(f"phase 15 (b): the model misses {len(missed)} of {len(out)} "
                             f"calls beyond {MODEL_RTOL_WS1}: {missed}")
    log(f"phase 15 (b): {len(out)} NCCL calls at world size 1, predicted growth within "
        f"{worst:.4f} of max_memory_allocated's (limit {MODEL_RTOL_WS1})")
    return {"calls": out, "worst_rel_err": worst}


def dryrun_local_mesh(plan, full):
    """(c): phase 12 (b)'s LocalMesh P = 4 u12-2 cell (B = 2), every mode x
    fuse: the model of the process at both ends, the split tables once and
    each rank's arguments, then either each rank's settled bytes (what it
    holds between its ops) and the largest one rank's excess over them (the
    serial end: the thread ranks reach their peaks one at a time) or every
    rank's peak at once (the aligned end).  Whether the four ranks coincide
    varies from call to call (pipeline-g1 measured 27.58 and 29.79 GB on the
    same code), so each measured peak, the most of phase 12 (b)'s
    2 + DIST_PEAK_CALLS calls of the mode, is held inside [serial,
    aligned], each end widened by MODEL_RTOL_LOCAL, and the alltoall /
    pipeline ratio inside the interval the two ends give (alltoall's serial
    over pipeline's aligned to alltoall's aligned over pipeline's serial),
    widened by MODEL_RTOL_RATIO."""
    from repro_torch.comm import AbstractMesh
    from repro_torch.launch.dryrun import measure_rank

    P = plan.num_shards
    got, worst = {}, 0.0
    for mode, gf in DIST_MODES:
        for fuse in (False, True):
            label = f"{_dist_label(mode, gf)}{' fused' if fuse else ''}"
            ranks = [measure_rank(plan, AbstractMesh(P, rank=p), batch=DIST_BATCH, mode=mode,
                                  group_factor=gf, fuse=fuse)["memory"] for p in range(P)]
            shared = ranks[0]["shared_bytes"]
            pred = shared + sum(r["argument_bytes"] - shared + r["settled_bytes"]
                                for r in ranks) + max(
                r["temp_bytes"] + r["output_bytes"] - r["settled_bytes"] for r in ranks)
            meas = max(full["modes"][label]["peak_calls_bytes"])
            rel = abs(pred - meas) / meas
            worst = max(worst, rel)
            got[label] = {"predicted_peak_bytes": pred, "measured_peak_bytes": meas,
                          "rel_err": rel, "predicted_plan_bytes": shared + sum(
                              r["argument_bytes"] - shared - r["colorings_bytes"] for r in ranks),
                          "measured_before_bytes": full["modes"][label]["allocated_before_bytes"],
                          "rank_temp_bytes": [r["temp_bytes"] for r in ranks],
                          "rank_settled_bytes": [r["settled_bytes"] for r in ranks],
                          "aligned_peak_bytes": shared + sum(
                              r["argument_bytes"] - shared + r["temp_bytes"]
                              + r["output_bytes"] for r in ranks)}
            log(f"phase 15 (c) {label}: measured peak {meas} B, predicted {pred} B serial "
                f"(rel {rel:.4f}) to {got[label]['aligned_peak_bytes']} B aligned; plan bytes "
                f"predicted {got[label]['predicted_plan_bytes']}, allocated before the call "
                f"{got[label]['measured_before_bytes']}")
    def outside(x, lo, hi, tol):
        """How far ``x`` lies outside ``[lo (1 - tol), hi (1 + tol)]``,
        relative to the nearer end (0 inside)."""
        lo, hi = lo * (1 - tol), hi * (1 + tol)
        return max(lo - x, x - hi, 0.0) / (lo if x < lo else hi)

    missed = []
    for label, v in got.items():
        v["outside"] = outside(v["measured_peak_bytes"], v["predicted_peak_bytes"],
                               v["aligned_peak_bytes"], MODEL_RTOL_LOCAL)
        if v["outside"]:
            missed.append((label, v["outside"]))
    ratios = {}
    for suffix in ("", " fused"):
        a, p = got["alltoall" + suffix], got["pipeline-g1" + suffix]
        lo = a["predicted_peak_bytes"] / p["aligned_peak_bytes"]
        hi = a["aligned_peak_bytes"] / p["predicted_peak_bytes"]
        model = a["predicted_peak_bytes"] / p["predicted_peak_bytes"]
        meas = a["measured_peak_bytes"] / p["measured_peak_bytes"]
        off = outside(meas, lo, hi, MODEL_RTOL_RATIO)
        ratios["unfused" if not suffix else "fused"] = {
            "model": model, "model_interval": [lo, hi], "measured": meas,
            "rel_err": abs(model - meas) / meas, "outside": off}
        log(f"phase 15 (c) alltoall / pipeline peak{suffix or ' unfused'}: measured {meas:.4f}, "
            f"the model's interval [{lo:.4f}, {hi:.4f}] (serial ends {model:.4f}; outside by "
            f"{off:.4f} beyond {MODEL_RTOL_RATIO})")
        if off:
            missed.append((f"alltoall / pipeline{suffix}", off))
    if missed:
        raise AssertionError(f"phase 15 (c): measured outside the model's [serial, aligned] "
                             f"beyond {MODEL_RTOL_LOCAL} (peaks) or {MODEL_RTOL_RATIO} (ratios): "
                             f"{missed}")
    return {"modes": got, "ratio": ratios, "worst_rel_err": worst}


def timed_rows(kernel_rows, dense_rows, dags, sparse_rows, dist_rows, compact_rows, flash):
    """Every (kernel, row) that phases 2-14 timed beside a bound."""
    out = [(k, r) for k, rs in kernel_rows.items() for r in rs]
    out += [("spmm_block", r) for r in dense_rows]
    for d_rows, _ in dags.values():
        out += [(k, r) for k, rs in d_rows.items() for r in rs]
    for group in (sparse_rows, dist_rows, compact_rows):
        out += [(k, r) for k, rs in group.items() for r in rs]
    return out + [(name, row) for name, row in zip(
        ("flash_attention", "flash_attention_fp32", "flash_attention", "flash_attention_fp32"),
        flash)]


def dryrun_bounds(rows):
    """(d): no kernel time of phases 2-14 below the bound its work count
    gives (it would mean the count is wrong)."""
    low = [(k, r["shape"], r["ms"], r["bound"][0]) for k, r in rows if r["ms"] < r["bound"][0]]
    if low:
        raise AssertionError(f"phase 15 (d) times below their bound: {low}")
    tight = min(rows, key=lambda kr: kr[1]["ms"] / kr[1]["bound"][0])
    log(f"phase 15 (d): {len(rows)} kernel times at or above their bounds; the tightest "
        f"{tight[0]} {tight[1]['shape']}: {tight[1]['ms']:.4g} ms against "
        f"{tight[1]['bound'][0]:.4g}")
    return {"rows_checked": len(rows), "tightest": {
        "kernel": tight[0], "shape": tight[1]["shape"], "ms": tight[1]["ms"],
        "bound_ms": tight[1]["bound"][0]}}


def phase_dryrun(model_inputs, full, rows):
    """Phase 15: (a)-(d)."""
    t0 = time.perf_counter()
    cells = dryrun_rows()
    ws1 = dryrun_world_size_1(model_inputs["nccl"], model_inputs["growth"])
    local = dryrun_local_mesh(model_inputs["u12"], full)
    bounds = dryrun_bounds(rows)
    dt = time.perf_counter() - t0
    log(f"phase 15 passed in {dt:.1f}s")
    return {"cells": cells, "world_size_1": ws1, "local_mesh": local, "bounds": bounds,
            "seconds": dt}


# ---------------------------------------------------------------------------
# phase 16: the other six rows served
# ---------------------------------------------------------------------------

#: row: (layers kept, or None for full depth; prompts; tokens a prompt).  Depth
#: is cut where the full row passes the card (llama-3.2-vision-90b keeps one
#: pattern group of five, phi3.5-moe four layers, mixtral two); widths never.
LM_ROWS = {
    "llama-3.2-vision-90b": (5, 2, 4096),
    "whisper-base": (None, 4, 448),
    "phi3.5-moe-42b-a6.6b": (4, 4, 4096),
    "mixtral-8x22b": (2, 2, 6144),  # past the 4096 window: windowed flash, a wrapped cache
    "rwkv6-3b": (None, 4, 4096),
    "recurrentgemma-2b": (None, 2, 4096),
}
LM_ROWS_DECODE = 16  # greedy decode steps a row (cut from 32 for the script's time)
LM_ROWS_CHECK_LEN = 31  # float32 decode-vs-forward prompt: rwkv's forward over 32 is one chunk
LM_ROWS_CARD_CPU_LEN = 128  # tokens of each block kind's card-vs-CPU prefill
LM_ROWS_CONTEXT_SCALE = 0.1  # image-patch and frame embeddings, as the reference's tests draw them
#: (b) moe_block_manual on LocalMesh P = 4, full width, float32: (label, row,
#: pipeline, group factor, batch shape)
MOE_MANUAL = (("phi3.5 ep fused", "phi3.5-moe-42b-a6.6b", False, 1, (4, 1024)),
              ("phi3.5 ep pipeline g1", "phi3.5-moe-42b-a6.6b", True, 1, (4, 1024)),
              ("phi3.5 ep pipeline g2", "phi3.5-moe-42b-a6.6b", True, 2, (4, 1024)),
              ("phi3.5 replicated-token fallback", "phi3.5-moe-42b-a6.6b", False, 1, (3, 1)),
              ("mixtral tp", "mixtral-8x22b", False, 1, (2, 1024)))
MOE_MANUAL_SHARDS = 4
MOE_MANUAL_TOL = 2e-4  # the reference's manual-vs-dense tolerance (tests/_dist_worker.py)


def lm_row_cfg(name: str):
    import dataclasses

    from repro_torch.configs import get_arch

    cfg = get_arch(name)
    layers = LM_ROWS[name][0]
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def no_drop(cfg):
    """``cfg`` at the capacity factor at which no expert can drop a token
    (E / k: an expert's capacity is then the token count)."""
    import dataclasses

    if not cfg.num_experts:
        return cfg
    return dataclasses.replace(cfg, capacity_factor=cfg.num_experts / cfg.experts_per_token)


def flash_layers(cfg) -> int:
    """Self-attention launches of one prefill: ``attn``, ``local`` and
    ``attn_cross`` layers, and the encoder's."""
    from repro_torch.models.transformer import layer_kinds

    return (sum(k in ("attn", "local", "attn_cross") for k in layer_kinds(cfg))
            + cfg.encoder_layers)


def lm_row_flash_shapes():
    """Each self-attention launch shape of phase 16's prefills, once:
    ``(B, Hq, Hkv, L, D, causal, window)`` of the ``attn``, ``local`` and
    ``attn_cross`` layers and of the encoder's (bidirectional, over its
    frames)."""
    from repro_torch.models.transformer import layer_kinds

    shapes = []
    for name, (_, batch, length) in LM_ROWS.items():
        cfg = lm_row_cfg(name)
        heads = (cfg.num_heads, cfg.num_kv_heads)
        d = cfg.resolved_head_dim
        for kind in dict.fromkeys(layer_kinds(cfg)):
            if kind in ("attn", "local", "attn_cross"):
                window = cfg.local_window if kind == "local" else cfg.window
                shapes.append((batch, *heads, length, d, True, window))
        if cfg.encoder_layers:
            shapes.append((batch, *heads, cfg.encoder_context, d, False, 0))
    return list(dict.fromkeys(shapes))


def lm_row_inputs(cfg, batch: int, length: int, gen, dev):
    """A prompt ``[batch, length]`` and the row's context (image patches or
    frames), drawn from ``gen``."""
    import torch
    from repro_torch.models.factory import context_len

    out = {"tokens": torch.randint(0, cfg.vocab_size, (batch, length), generator=gen, device=dev)}
    lc, needed = context_len(cfg)
    if needed:
        out["context"] = torch.randn((batch, lc, cfg.d_model), generator=gen,
                                     device=dev) * LM_ROWS_CONTEXT_SCALE
    return out


def draw_gates(params, gen):
    """``xgate`` is zero at init (a cross block starts as a no-op): draw it."""
    import torch

    for blk in params.blocks:
        if hasattr(blk, "xgate"):
            blk.xgate.copy_(torch.randn((), generator=gen, device=blk.xgate.device))


def lm_row_decode_check(params, cfg, inputs, dev):
    """On a short prompt, at the capacity that drops no token: the bf16
    decode step (over the reference's bf16 cache) and forward, then the
    same weights in float32 (in place): the float32 decode step == a
    forward over L + 1 tokens within LM_DECODE_TOL, and the bf16 decode step
    no more than LM_BF16_RATIO times as far from that float32 forward as the
    bf16 forward.

    The float32 prefill keeps its keys and values in float32
    (``cache_dtype``), so the gate reads the decode path's own distance from
    the forward.  The same step over that cache rounded to bf16 (the served
    cache) is reported beside and read by no gate: at full width the
    cache's rounding alone can pass 2e-2 (llama-3.2-vision-90b: 0.024 on the
    card), so the gate as first set, on the served cache, is not met there
    (ROADMAP queue 3)."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.transformer import encode, forward

    cfg = no_drop(cfg)
    params.cfg = cfg  # the same weights under the no-drop config, which build_model checks
    n = LM_ROWS_CHECK_LEN
    toks = inputs["tokens"][:, : n + 1]
    ctx_in = inputs.get("context")
    v = cfg.vocab_size

    def rounded(caches):
        """The caches with their keys and values in bf16, as served."""
        return [{name: t.to(torch.bfloat16) if name in ("k", "v") else t.clone()
                 for name, t in c.items()} for c in caches]

    def run(dtype):
        model = build_model(cfg, dtype=dtype, device=dev, cache_dtype=dtype)
        batch = {"tokens": toks[:, :n]}
        if ctx_in is not None:
            batch["context"] = ctx_in
        _, caches = model.prefill_fn(params, batch)
        served = rounded(caches) if dtype == torch.float32 else None
        step = {"tokens": toks[:, n:], "pos": n}
        dec, _ = model.decode_fn(params, dict(step, caches=caches))
        dec_served = None
        if served is not None:
            dec_served = model.decode_fn(params, dict(step, caches=served))[0][:, :v]
        ctx = None
        if ctx_in is not None:
            ctx = encode(params, cfg, ctx_in, dtype=dtype) if cfg.family == "audio" \
                else ctx_in.to(dtype)
        with torch.no_grad():
            full, _, _ = forward(params, cfg, toks, context=ctx, mode="train", dtype=dtype)
        return dec[:, :v], full[:, -1, :v].clone(), dec_served

    dec16, fwd16, _ = run(torch.bfloat16)
    params.float()
    dec32, fwd32, dec32_served = run(torch.float32)
    err = (dec32 - fwd32).abs().max().item()
    if not torch.allclose(dec32, fwd32, rtol=LM_DECODE_TOL, atol=LM_DECODE_TOL):
        raise AssertionError(f"{cfg.name}: float32 decode vs forward over {n + 1} tokens: max "
                             f"abs err {err} beyond {LM_DECODE_TOL}")
    dist = {"decode_vs_float32_forward": (dec16 - fwd32).abs().max().item(),
            "forward_vs_float32_forward": (fwd16 - fwd32).abs().max().item(),
            "float32_decode_bf16_cache_vs_forward": (dec32_served - fwd32).abs().max().item()}
    ratio = dist["decode_vs_float32_forward"] / dist["forward_vs_float32_forward"]
    if not ratio <= LM_BF16_RATIO:
        raise AssertionError(f"{cfg.name}: bf16 decode step is {ratio:.3g}x as far from the "
                             f"float32 forward as the bf16 forward, beyond {LM_BF16_RATIO}: {dist}")
    return err, ratio, dist


def block_card_vs_cpu(params, cfg, dev, gen):
    """Each block kind of the row (its first layer of each kind; whisper's
    encoder whole), full width in float32: its prefill on the card == the
    CPU's on the same weights within LM_CARD_CPU_RTOL relative."""
    import copy

    import torch
    from repro_torch.models.transformer import cache_buffer_len, encode

    cfg = no_drop(cfg)
    l = LM_ROWS_CARD_CPU_LEN
    h = torch.randn((1, l, cfg.d_model), generator=gen, device=dev)
    ctx = None
    lc = cfg.num_image_tokens or cfg.encoder_context
    if any(k in ("cross", "attn_cross") for k in cfg.block_pattern):
        ctx = torch.randn((1, lc, cfg.d_model), generator=gen, device=dev)
    out = {}
    seen = set()
    kinds = [(blk.kind + ("+experts" if cfg.num_experts else ""), blk) for blk in params.blocks]
    for kind, blk in kinds:
        if kind in seen:
            continue
        seen.add(kind)
        cpu = copy.deepcopy(blk).to("cpu")
        kw = dict(mode="prefill", dtype=torch.float32, s_buf=cache_buffer_len(cfg, l))
        with torch.no_grad():
            got = blk(h, cfg, context=ctx, **kw)[0]
            want = cpu(h.cpu(), cfg, context=None if ctx is None else ctx.cpu(), **kw)[0]
        out[kind] = rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
        del cpu
        if not rel <= LM_CARD_CPU_RTOL:
            raise AssertionError(f"{cfg.name} {kind} block: card vs CPU relative error {rel}")
    if params.encoder is not None:
        frames = torch.randn((1, cfg.encoder_context, cfg.d_model), generator=gen, device=dev)
        enc_cpu = copy.deepcopy(params).to("cpu")
        with torch.no_grad():
            got = encode(params, cfg, frames, dtype=torch.float32)
            want = encode(enc_cpu, cfg, frames.cpu(), dtype=torch.float32)
        out["encoder"] = rel = (got.cpu() - want).abs().max().item() / want.abs().max().item()
        if not rel <= LM_CARD_CPU_RTOL:
            raise AssertionError(f"{cfg.name} encoder: card vs CPU relative error {rel}")
    return out


def lm_row(name: str, dev, gen):
    """One row served: weights, one warm and LM_TIMED timed prefills, then
    LM_ROWS_DECODE greedy decode steps; the flash launches per prefill; then the
    float32 checks.  Returns the row's record and its two paths' launches."""
    import torch
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model

    cfg = lm_row_cfg(name)
    _, batch, length = LM_ROWS[name]
    model = build_model(cfg, cast_params=True, device=dev)
    t0 = time.perf_counter()
    params = model.init_fn(gen)
    draw_gates(params, gen)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    init_s = time.perf_counter() - t0
    inputs = lm_row_inputs(cfg, batch, length, gen, dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = read_launches()
    logits, caches = model.prefill_fn(params, inputs)
    torch.cuda.synchronize()
    prefill_s, per_prefill = [], []
    for _ in range(LM_TIMED):
        del logits, caches
        n0 = flash_attention.launches_wgmma
        t0 = time.perf_counter()
        logits, caches = model.prefill_fn(params, inputs)
        torch.cuda.synchronize()
        prefill_s.append(time.perf_counter() - t0)
        per_prefill.append(flash_attention.launches_wgmma - n0)
    if not torch.isfinite(logits).all() or logits.shape != (batch, cfg.padded_vocab):
        raise AssertionError(f"{name}: bad prefill logits {tuple(logits.shape)}")
    tok = logits.argmax(-1, keepdim=True)
    t0 = time.perf_counter()
    for i in range(LM_ROWS_DECODE):
        step, caches = model.decode_fn(params, {"tokens": tok, "pos": length + i, "caches": caches})
        if not torch.isfinite(step).all():
            raise AssertionError(f"{name}: decode step {i} gave logits that are not finite")
        tok = step.argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) / LM_ROWS_DECODE * 1e3
    peak = torch.cuda.max_memory_allocated(dev)
    served = {k: v - before[k] for k, v in read_launches().items()}
    want = flash_layers(cfg)
    if per_prefill != [want] * LM_TIMED or served["flash_attention_fp32"]:
        raise AssertionError(f"{name}: bf16 flash launches per prefill {per_prefill}, want {want} "
                             f"on the wgmma route; launches {served}")
    wrapped = None
    if cfg.window:
        slots = caches[0]["k"].shape[2]
        wrapped = {"cache_slots": slots, "positions": length + LM_ROWS_DECODE}
        if slots >= length:
            raise AssertionError(f"{name}: the windowed cache ({slots} slots) did not wrap")
    del logits, caches, step
    torch.cuda.empty_cache()
    prefill_ms = min(prefill_s) * 1e3
    log(f"phase 16 {name} ({cfg.num_layers} layers, {n_params} parameters, "
        f"{weight_bytes / 1e9:.2f} GB drawn in {init_s:.1f}s) B={batch} L={length}: prefill "
        f"{[round(t * 1e3, 1) for t in prefill_s]} ms ({batch * length / min(prefill_s):.0f} "
        f"tokens/s); decode {decode_ms:.2f} ms/step; peak {peak / 2 ** 30:.2f} GiB; wgmma flash "
        f"launches per prefill {per_prefill}" + (f"; wrapped cache {wrapped}" if wrapped else ""))
    before = read_launches()
    t0 = time.perf_counter()
    dec_err, ratio, dist = lm_row_decode_check(params, cfg, inputs, dev)
    card_cpu = block_card_vs_cpu(params, cfg, dev, gen)
    checks = {k: v - before[k] for k, v in read_launches().items()}  # bf16 and float32 runs
    log(f"phase 16 {name}: float32 decode (float32 cache) == forward over "
        f"{LM_ROWS_CHECK_LEN + 1} tokens within "
        f"{LM_DECODE_TOL} (max abs err {dec_err:.3g}); bf16 decode {ratio:.3g}x as far from the "
        f"float32 forward as the bf16 forward (limit {LM_BF16_RATIO}; {dist}); card == CPU per "
        f"block kind (relative) {card_cpu} ({time.perf_counter() - t0:.1f}s)")
    del params, model
    torch.cuda.empty_cache()
    return dict(layers=cfg.num_layers, block_pattern=list(cfg.block_pattern), batch=batch,
                prompt_len=length, n_params=n_params, weight_bytes=weight_bytes,
                prefill_ms=prefill_ms, prefill_ms_runs=[t * 1e3 for t in prefill_s],
                tokens_per_s=batch * length / min(prefill_s), decode_ms_per_step=decode_ms,
                peak_bytes=peak, flash_launches_per_prefill=per_prefill[0],
                wrapped_cache=wrapped, decode_vs_forward_max_abs_err_float32=dec_err,
                bf16_decode_over_forward_distance=ratio, bf16_max_abs_distances=dist,
                card_vs_cpu_rel_err=card_cpu), served, checks


def moe_manual(dev, gen):
    """(b): moe_block_manual on LocalMesh P = 4 thread ranks sharing the
    card, one full-width layer in float32, each mode == moe_block on the
    same weights within MOE_MANUAL_TOL; a warm then a timed call, and the
    peak bytes above the weights."""
    import torch
    from repro_torch.comm import LocalMesh
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import Initializer
    from repro_torch.models.moe import moe_block, moe_block_manual, moe_init, shard_expert_weights

    out = {}
    weights = {}
    for label, name, pipeline, gf, shape in MOE_MANUAL:
        cfg = no_drop(get_arch(name))
        if name not in weights:
            weights.clear()
            torch.cuda.empty_cache()
            weights[name] = moe_init(Initializer(gen, device=dev), cfg)
        p = weights[name]
        x = torch.randn((*shape, cfg.d_model), generator=gen, device=dev) * 0.3
        with torch.no_grad():
            want, aux_want = moe_block(p, x, cfg, dtype=torch.float32)
        mesh = LocalMesh(MOE_MANUAL_SHARDS, device=dev)

        def rank(ctx):
            mine = shard_expert_weights(p, cfg, ctx.data.rank, ctx.data.size)
            with torch.no_grad():
                return moe_block_manual(mine, x, cfg, group=ctx.data, pipeline=pipeline,
                                        group_factor=gf, dtype=torch.float32)

        outs = mesh.run(rank)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        outs = mesh.run(rank)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated(dev) - base
        err = max((o - want).abs().max().item() for o, _ in outs)
        if not all(torch.allclose(o, want, rtol=MOE_MANUAL_TOL, atol=MOE_MANUAL_TOL)
                   for o, _ in outs):
            raise AssertionError(f"phase 16 (b) {label}: max abs err {err} beyond "
                                 f"{MOE_MANUAL_TOL} of moe_block")
        t0 = time.perf_counter()
        with torch.no_grad():
            moe_block(p, x, cfg, dtype=torch.float32)
        torch.cuda.synchronize()
        dense_ms = (time.perf_counter() - t0) * 1e3
        out[label] = dict(tokens=shape[0] * shape[1], ms=ms, dense_ms=dense_ms, peak_bytes=peak,
                          max_abs_err=err, aux=outs[0][1].item(), dense_aux=aux_want.item())
        log(f"phase 16 (b) {label} ({shape[0] * shape[1]} tokens, P={MOE_MANUAL_SHARDS}): == "
            f"moe_block within {MOE_MANUAL_TOL} (max abs err {err:.3g}); {ms:.1f} ms a call "
            f"(moe_block {dense_ms:.1f}); peak {peak / 2 ** 30:.2f} GiB above the inputs")
        del outs, want, x
    weights.clear()
    torch.cuda.empty_cache()
    return out


def phase_lm_rows(dev):
    """Phase 16: every row beyond the dense ones served at full width, and
    (b) the distributed expert layer."""
    import torch

    gen = torch.Generator(device=dev)
    t_start = time.perf_counter()
    rows, served, checks = {}, {}, {}
    for i, name in enumerate(LM_ROWS):
        gen.manual_seed(100 + i)
        rows[name], s, c = lm_row(name, dev, gen)
        for acc, d in ((served, s), (checks, c)):
            for k, v in d.items():
                acc[k] = acc.get(k, 0) + v
        if name == "recurrentgemma-2b":  # the only row at D = 256
            d256 = {"lm_rows": s["flash_attention"],
                    "lm_rows_float32_checks": c["flash_attention_fp32"]}
    gen.manual_seed(200)
    manual = moe_manual(dev, gen)
    dt = time.perf_counter() - t_start
    log(f"phase 16 passed in {dt:.1f}s; launches served {served}, float32 checks {checks}")
    return served, checks, d256, {"rows": rows, "moe_manual": manual, "seconds": dt}


# ---------------------------------------------------------------------------
# phase 17: training
# ---------------------------------------------------------------------------

TRAIN_ARCH = "smollm-360m"
TRAIN_BATCH, TRAIN_LEN = 8, 2048  # (a): sequences a step, tokens a sequence
TRAIN_WARM, TRAIN_TIMED, TRAIN_RESUMED = 2, 4, 2  # (a): steps
TRAIN_RESUME_LAYERS = 2  # (a): the resume check's depth (full width)
#: (a): the resume check's steps before its checkpoint; more than
#: TRAIN_RESUMED, so that the run's last step is not a checkpoint too
TRAIN_RESUME_AT = 3
#: the reference's peak learning rate after 2 warmup steps (its 200 would
#: keep the rate near 0 for a dozen steps); 1e-3 made the loss spike
TRAIN_OPT = dict(lr_peak=3e-4, warmup_steps=2)
TRAIN_RESUME_RTOL = 1e-6  # (a): resumed == uninterrupted, relative, per weight
TRAIN_MOE = ("phi3.5-moe-42b-a6.6b", 1, 4, 2048, 4)  # (b): row, layers, B, L, steps
TRAIN_CARD_CPU_RTOL = 1e-4  # (c): float32 on both sides, TF32 off
TRAIN_CARD_CPU_SHAPE = (2, 64)  # (c): each reduced row's batch
TRAIN_WHOLE_CPU_SHAPE = (1, 256)  # (c): smollm-360m whole
RING_SHARDS, RING_ELEMS = 4, 1 << 26  # (d): ranks, float32 gradient elements a rank
BF16_PEAK = 989e12  # dense bf16 tensor-core flop/s of an H100 SXM (data sheet)


def _train_log():
    """A ``train`` log that stamps each line with the host clock: a step's
    line comes after ``float(loss)``, a sync, so the gaps are step times."""
    lines, stamps = [], []

    def log_line(msg):
        stamps.append(time.perf_counter())
        lines.append(msg)

    return log_line, lines, stamps


def _step_losses(lines):
    return [float(x.split("loss ")[1].split()[0]) for x in lines if x.startswith("step ")]


def _rel_errs(got, want):
    """Per weight ``|got - want| / |want|`` (0 where both are 0)."""
    out = {}
    for k, w in want.items():
        g = got[k].detach().to(w.device)
        den = w.norm().item()
        out[k] = (g - w).norm().item() / den if den else float((g - w).norm().item() != 0)
    return out


def train_split(model, cfg, run, data, step_i, tcfg):
    """(a)'s step under torch.profiler (device time by kind, busy share; the
    host's share is the wall time the device was idle), and its parts timed
    alone with CUDA events: one layer's chunked attention forward and
    forward+backward (a step runs the layers' attention forward, the remat
    recompute and the backward), the chunked CE forward and backward, one
    ``adamw_update``."""
    import torch
    from repro_torch.models.attention import chunked_attention
    from repro_torch.models.factory import chunked_ce_loss
    from repro_torch.train import adamw_update, make_train_step, synthetic_batch

    step, _ = make_train_step(model, tcfg)
    batch = synthetic_batch(data, step_i, model.device)
    st = {"p": run["params"], "o": run["opt"]}

    def one():
        st["p"], st["o"], m = step(st["p"], st["o"], batch)
        float(m["loss"])

    split = device_split(one, host_ops=False)
    if not split["device_busy_ms"]:
        raise AssertionError(f"phase 17 (a): the profiler saw no kernel of the step: {split}")
    dev = model.device
    b, l, hd = TRAIN_BATCH, TRAIN_LEN, cfg.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(3)

    def leaf(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev, dtype=dtype).requires_grad_(True)

    q, k, v = leaf(b, cfg.num_heads, l, hd), leaf(b, cfg.num_kv_heads, l, hd), \
        leaf(b, cfg.num_kv_heads, l, hd)
    r = torch.randn_like(q)
    attn_fwd = cuda_ms(lambda: chunked_attention(q, k, v, causal=True), reps=2)
    attn_fb = cuda_ms(lambda: torch.autograd.backward(chunked_attention(q, k, v, causal=True), r),
                      reps=2)
    del q, k, v, r
    h = leaf(b, l - 1, cfg.d_model)
    head = (st["p"].embed.T if st["p"].lm_head is None else st["p"].lm_head)
    head = head.detach().clone().requires_grad_(True)
    labels = batch["tokens"][:, 1:]
    ce = cuda_ms(lambda: chunked_ce_loss(h, head, labels, vocab_size=cfg.vocab_size).backward(),
                 reps=2)
    del h, head
    weights = dict(st["p"].named_parameters())
    grads = {n: torch.randn(w.shape, generator=gen, device=dev) * 1e-3 for n, w in weights.items()}
    opt_ms = cuda_ms(lambda: adamw_update(tcfg.opt, weights, grads, st["o"]), reps=2)
    del grads, weights, st
    parts = {"attention_layer_forward_ms": attn_fwd, "attention_layer_forward_backward_ms": attn_fb,
             "attention_step_ms": cfg.num_layers * (attn_fwd + attn_fb),
             "chunked_ce_forward_backward_ms": ce, "adamw_update_ms": opt_ms,
             "host_ms": split["wall_ms"] - split["device_busy_ms"]}
    return split, parts


def train_tcfg(ckpt_dir=None, steps=TRAIN_WARM + TRAIN_TIMED):
    """(a)'s schedule, which phase 18 (a) shares: ``steps`` steps (TRAIN_WARM
    + TRAIN_TIMED) and TRAIN_RESUMED more, a checkpoint after the first part."""
    from repro_torch.train import AdamWConfig, TrainConfig

    return TrainConfig(steps=steps + TRAIN_RESUMED,
                       opt=AdamWConfig(total_steps=steps + TRAIN_RESUMED, **TRAIN_OPT),
                       checkpoint_dir=ckpt_dir, checkpoint_every=steps, log_every=1)


def train_resume(dev, tmp, data):
    """(a)'s resume check, at full width cut to TRAIN_RESUME_LAYERS layers:
    ``train`` for TRAIN_RESUME_AT + TRAIN_RESUMED steps with a checkpoint
    after TRAIN_RESUME_AT, then a fresh ``train`` resumes from it and takes
    the last TRAIN_RESUMED steps, whose weights must equal the uninterrupted run's
    within TRAIN_RESUME_RTOL relative.  The gate is not bitwise: on the card
    a reduction or scatter with atomics (an embedding's or an index's
    backward) may sum float32 terms in another order from run to run;
    whether the run was bitwise is recorded."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train import train

    cfg = dataclasses.replace(get_arch(TRAIN_ARCH), num_layers=TRAIN_RESUME_LAYERS)
    model = build_model(cfg, device=dev)
    steps = TRAIN_RESUME_AT
    tcfg = train_tcfg(str(tmp / TRAIN_ARCH), steps)
    lines = []
    t0 = time.perf_counter()
    run = train(model, tcfg, log=lines.append, data=data)
    want = {k: v.detach().clone() for k, v in run["params"].named_parameters()}
    del run
    resumed_lines = []
    resumed = train(model, tcfg, log=resumed_lines.append, data=data)
    resume_s = time.perf_counter() - t0
    if resumed_lines[0] != f"restored checkpoint at step {steps}":
        raise AssertionError(f"phase 17 (a): the resumed run logged {resumed_lines}")
    errs = _rel_errs(dict(resumed["params"].named_parameters()), want)
    worst = max(errs, key=errs.get)
    bitwise = all(torch.equal(v, want[k]) for k, v in resumed["params"].named_parameters())
    if not errs[worst] <= TRAIN_RESUME_RTOL:
        raise AssertionError(f"phase 17 (a): resumed weights {worst} {errs[worst]} from the "
                             f"uninterrupted run's")
    losses, resumed_losses = _step_losses(lines), _step_losses(resumed_lines)
    log(f"phase 17 (a) resume at {TRAIN_RESUME_LAYERS} layers: resumed at step {steps}, "
        f"{TRAIN_RESUMED} more steps ({resume_s:.1f}s for both runs): weights == the "
        f"uninterrupted run's within {TRAIN_RESUME_RTOL} (worst {worst} {errs[worst]:.3g}; "
        f"bitwise {bitwise}); losses {resumed_losses} against {losses[steps:]}")
    del resumed, want
    torch.cuda.empty_cache()
    return dict(layers=TRAIN_RESUME_LAYERS, step=steps, rel_err_worst=errs[worst],
                worst_weight=worst, bitwise=bitwise, losses=resumed_losses, seconds=resume_s)


def train_smollm(dev, tmp):
    """(a) smollm-360m whole at full width: TRAIN_WARM + TRAIN_TIMED steps of
    ``train`` and TRAIN_RESUMED more; the profiled step and its parts; then
    the resume check at a cut depth (:func:`train_resume`)."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train import DataConfig, train

    cfg = get_arch(TRAIN_ARCH)
    model = build_model(cfg, device=dev)
    steps = TRAIN_WARM + TRAIN_TIMED
    data = DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_LEN, seed=0)
    tcfg = train_tcfg()
    log_line, lines, stamps = _train_log()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)  # what the process holds beside this cell
    before = read_launches()
    t0 = time.perf_counter()
    run = train(model, tcfg, log=log_line, data=data)
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: v - before[k] for k, v in read_launches().items()}
    losses = _step_losses(lines)
    step_s = [b - a for a, b in zip(stamps[TRAIN_WARM - 1 : steps - 1], stamps[TRAIN_WARM:steps])]
    gnorm = float(run["metrics"]["grad_norm"])
    if not (all(math.isfinite(x) for x in losses) and math.isfinite(gnorm)):
        raise AssertionError(f"phase 17 (a): losses {losses}, gradient norm {gnorm}")
    if not sum(losses[steps - 4 : steps]) / 4 < losses[0]:
        raise AssertionError(f"phase 17 (a): the loss did not fall over {steps} steps (the "
                             f"mean of the last 4 against the first): {losses}")
    if any(launched.values()):
        raise AssertionError(f"phase 17 (a): the train path launched kernels {launched}")
    ms = sum(step_s) / len(step_s) * 1e3
    tokens = TRAIN_BATCH * TRAIN_LEN
    n_params = cfg.params_count()
    log(f"phase 17 (a) {TRAIN_ARCH} ({cfg.num_layers} layers, {n_params} parameters by "
        f"params_count) B={TRAIN_BATCH} L={TRAIN_LEN}: {ms:.1f} ms a step over "
        f"{len(step_s)} timed steps {[round(x * 1e3, 1) for x in step_s]}, "
        f"{tokens / ms * 1e3:.0f} tokens/s, peak {peak / 2 ** 30:.2f} GiB, losses {losses}, "
        f"gnorm {gnorm:.3g} ({time.perf_counter() - t0:.1f}s)")
    train_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    split, parts = train_split(model, cfg, run, data, steps + TRAIN_RESUMED, tcfg)
    split_s = time.perf_counter() - t0
    del run
    torch.cuda.empty_cache()
    log(f"phase 17 (a) the step under the profiler: {split}; alone: {parts} ({split_s:.1f}s)")
    resume = train_resume(dev, tmp, data)
    return dict(arch=TRAIN_ARCH, layers=cfg.num_layers, n_params=n_params, batch=TRAIN_BATCH,
                seq_len=TRAIN_LEN, compute="bf16, float32 weights and AdamW state",
                remat=model.sharding.remat, ms_per_step=ms, step_ms_runs=[x * 1e3 for x in step_s],
                tokens_per_s=tokens / ms * 1e3, peak_bytes=peak, held_bytes=held,
                model_flops_share=6 * n_params * tokens / (ms / 1e3 * BF16_PEAK),
                losses=losses, grad_norm=gnorm, launches=launched, seconds=train_s,
                profiled_step=split, parts_alone=parts, split_seconds=split_s, resume=resume)


def train_moe(dev):
    """(b) phi3.5-moe at full width, one layer: TRAIN_MOE's steps; the aux
    loss of every expert-layer call finite and positive, every expert's and
    the router's AdamW first moment nonzero after the steps (each took a
    gradient), a finite loss; ms a step (after the first) and peak bytes."""
    import dataclasses

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, transformer
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig, init_opt_state,
                                   make_train_step, synthetic_batch)

    name, layers, b, l, nsteps = TRAIN_MOE
    cfg = dataclasses.replace(get_arch(name), num_layers=layers)
    model = build_model(cfg, device=dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params = model.init_fn(torch.Generator(device=dev).manual_seed(17))
    n_params = sum(p.numel() for p in params.parameters())
    params.requires_grad_(True)
    opt = init_opt_state(dict(params.named_parameters()))
    step, _ = make_train_step(model, TrainConfig(opt=AdamWConfig(total_steps=nsteps, **TRAIN_OPT)))
    data = DataConfig(cfg.vocab_size, b, l, seed=1)
    auxes, real = [], transformer.moe_block

    def spy(*args, **kwargs):
        out, aux = real(*args, **kwargs)
        auxes.append(float(aux.detach()))
        return out, aux

    transformer.moe_block = spy
    before = read_launches()
    times, losses = [], []
    try:
        for i in range(nsteps):
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, synthetic_batch(data, i, dev))
            losses.append(float(m["loss"]))
            times.append(time.perf_counter() - t0)
    finally:
        transformer.moe_block = real
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: v - before[k] for k, v in read_launches().items()}
    moved = {w: int((opt["m"][f"blocks.0.ffn.{w}"].abs().amax(dim=tuple(range(1, 3))) > 0).sum())
             for w in ("w_gate", "w_up", "w_down")}
    router_moved = bool(opt["m"]["blocks.0.ffn.router"].abs().amax() > 0)
    if not (auxes and all(math.isfinite(a) and a > 0 for a in auxes)
            and all(math.isfinite(x) for x in losses)):
        raise AssertionError(f"phase 17 (b): aux {auxes}, losses {losses}")
    if not (router_moved and all(n == cfg.num_experts for n in moved.values())):
        raise AssertionError(f"phase 17 (b): experts with a gradient {moved}, router "
                             f"{router_moved}")
    if any(launched.values()):
        raise AssertionError(f"phase 17 (b): the train path launched kernels {launched}")
    ms = sum(times[1:]) / len(times[1:]) * 1e3
    log(f"phase 17 (b) {name} (1 layer, {n_params} parameters) B={b} L={l}: {ms:.1f} ms a step "
        f"{[round(t * 1e3, 1) for t in times]}, {b * l / ms * 1e3:.0f} tokens/s, peak "
        f"{peak / 2 ** 30:.2f} GiB; losses {losses}; aux per call {[round(a, 4) for a in auxes]}; "
        f"experts with a gradient {moved} of {cfg.num_experts}")
    del params, opt, step, model
    torch.cuda.empty_cache()
    return dict(arch=name, layers=layers, n_params=n_params, batch=b, seq_len=l, steps=nsteps,
                ms_per_step=ms, step_ms_runs=[t * 1e3 for t in times], peak_bytes=peak,
                losses=losses, aux=auxes, experts_with_gradient=moved, launches=launched)


def _loss_and_grads(model, params, batch):
    import torch

    params.requires_grad_(True)
    loss = model.loss_fn(params, batch)
    names = [n for n, _ in params.named_parameters()]
    grads = torch.autograd.grad(loss, [w for _, w in params.named_parameters()])
    return loss.item(), dict(zip(names, grads))


def train_card_vs_cpu(dev):
    """(c) each row's reduced config and smollm-360m whole, float32: the loss
    and every gradient on the card == the CPU's on the same weights and
    batch within TRAIN_CARD_CPU_RTOL relative (a gradient against its own
    norm)."""
    import copy

    import torch
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models import build_model
    from repro_torch.models.factory import context_len
    from repro_torch.train import DataConfig, synthetic_batch

    cases = [(name, get_arch(name).reduced(), TRAIN_CARD_CPU_SHAPE) for name in ARCHS]
    cases.append((f"{TRAIN_ARCH} whole", get_arch(TRAIN_ARCH), TRAIN_WHOLE_CPU_SHAPE))
    out = {}
    before = read_launches()
    for i, (name, cfg, (b, l)) in enumerate(cases):
        gen = torch.Generator().manual_seed(i)
        batch = synthetic_batch(DataConfig(cfg.vocab_size, b, l, seed=i), 0, "cpu")
        n_ctx, needed = context_len(cfg)
        if needed:
            batch["context"] = torch.randn((b, n_ctx, cfg.d_model), generator=gen) * 0.1
        cpu_model = build_model(cfg, dtype=torch.float32, device="cpu")
        params = cpu_model.init_fn(gen)
        on_card = copy.deepcopy(params).to(dev)
        want_loss, want = _loss_and_grads(cpu_model, params, batch)
        got_loss, got = _loss_and_grads(build_model(cfg, dtype=torch.float32, device=dev),
                                        on_card, {k: v.to(dev) for k, v in batch.items()})
        errs = _rel_errs(got, want)
        worst = max(errs, key=errs.get)
        loss_err = abs(got_loss - want_loss) / abs(want_loss)
        out[name] = dict(loss_rel_err=loss_err, grad_rel_err_worst=errs[worst], worst_weight=worst,
                         batch=[b, l])
        if not (loss_err <= TRAIN_CARD_CPU_RTOL and errs[worst] <= TRAIN_CARD_CPU_RTOL):
            raise AssertionError(f"phase 17 (c) {name}: card vs CPU loss {loss_err}, {worst} "
                                 f"{errs[worst]}")
        del params, on_card, got, want
    launched = {k: v - before[k] for k, v in read_launches().items()}
    if any(launched.values()):
        raise AssertionError(f"phase 17 (c): the train path launched kernels {launched}")
    torch.cuda.empty_cache()
    log(f"phase 17 (c) card == CPU, float32 loss and gradients (relative): "
        + ", ".join(f"{k} {v['loss_rel_err']:.2g}/{v['grad_rel_err_worst']:.2g}"
                    for k, v in out.items()))
    return out


def train_ring(dev):
    """(d) the int8 gradient ring (``compressed_ring_reduce_scatter``) on
    LocalMesh RING_SHARDS thread ranks sharing the card, RING_ELEMS float32
    gradient elements a rank: == the same ring on the CPU (its plain
    simulation, LocalMesh on the CPU), bitwise; a warm then a timed call;
    the distance from the exact float32 sum."""
    import torch
    from repro_torch.comm import LocalMesh, compressed_ring_reduce_scatter

    p = RING_SHARDS
    chunk = RING_ELEMS // p
    x = torch.randn((p, p, chunk), generator=torch.Generator(device=dev).manual_seed(5),
                    device=dev)

    def ring(src):
        return lambda ctx: compressed_ring_reduce_scatter(ctx.data, src[ctx.data.rank])

    mesh = LocalMesh(p, device=dev)
    mesh.run(ring(x))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = mesh.run(ring(x))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    xc = x.cpu()
    t0 = time.perf_counter()
    want = LocalMesh(p, device="cpu").run(ring(xc))
    cpu_s = time.perf_counter() - t0
    if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
        raise AssertionError("phase 17 (d): the ring on the card != its CPU simulation")
    exact = xc.sum(0)
    err = max((w - exact[r]).abs().max().item() for r, w in enumerate(want))
    wire = (p - 1) * (chunk + chunk // 256 * 4)  # int8 values and float32 block scales, a rank
    log(f"phase 17 (d) int8 ring, LocalMesh P={p}, {RING_ELEMS} float32 elements a rank: == the "
        f"CPU simulation bitwise; {ms:.1f} ms a call on the card ({cpu_s:.1f}s on the CPU); "
        f"max abs err from the float32 sum {err:.3g}; {wire} bytes sent a rank")
    del x, got
    torch.cuda.empty_cache()
    return dict(shards=p, elements_per_rank=RING_ELEMS, ms=ms, cpu_s=cpu_s, bitwise=True,
                max_abs_err_vs_float32_sum=err, wire_bytes_per_rank=wire)


def phase_train(dev):
    """Phase 17: training (a)-(d); the train path launches none of the five
    kernels (self-attention trains through chunked_attention, as the
    reference trains through its XLA path)."""
    import shutil

    import torch

    torch.cuda.synchronize(dev)  # a context before the memory statistics are read
    t_start = time.perf_counter()
    out, part_s = {}, {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        for part, run in (("smollm", lambda: train_smollm(dev, tmp)),
                          ("moe", lambda: train_moe(dev)),
                          ("card_vs_cpu", lambda: train_card_vs_cpu(dev)),
                          ("int8_ring", lambda: train_ring(dev))):
            t0 = time.perf_counter()
            out[part] = run()
            part_s[part] = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["part_seconds"] = part_s
    out["seconds"] = dt = time.perf_counter() - t_start
    log(f"phase 17 passed in {dt:.1f}s ({', '.join(f'{k} {v:.1f}s' for k, v in part_s.items())})")
    return out


# ---------------------------------------------------------------------------
# phase 18: the LM on a mesh
# ---------------------------------------------------------------------------

MESH_TIMEOUT = 120.0  # s a LocalMesh rank waits for a peer before the phase fails
MESH_TRAIN = (2, 2)  # (a): data x model
MESH_TRAIN_RTOL = 1e-3  # (a): bf16 losses vs phase 17 (a)'s (test_twenty_steps_track_the_reference)
MESH_F32_LAYERS = 2  # (a): the float32 check's depth (full width)
MESH_F32_BATCH = 2  # (a): the float32 check's sequences (of TRAIN_LEN tokens)
MESH_F32_LOSS_RTOL = 1e-5  # (a), (c): float32 loss and gradient norm, relative
MESH_F32_GRAD_TOL = 1e-4  # (a): each gathered gradient leaf, of its largest entry
MESH_SERVE = (1, 4)  # (b): data x model
MESH_SERVE_DECODE = 16  # (b): greedy decode steps (cut from 32 for the script's time)
MESH_TRAIN_TIMED = 1  # (a): timed steps after TRAIN_WARM (cut from 4, then 2, for time)
MESH_SERVE_F32_LAYERS = 4  # (b): the float32 decode-vs-forward check's depth
MESH_MOE = ("phi3.5-moe-42b-a6.6b", 1, 4, 2048, 2)  # (c): row, layers, B, L, steps a mode
MESH_ROWS = ("smollm-360m", "qwen1.5-0.5b", "internlm2-1.8b", "granite-3-8b",
             "phi3.5-moe-42b-a6.6b", "mixtral-8x22b")  # (c): the rows a mesh runs
MESH_ROWS_SHAPE = (4, 64)  # (c): each reduced row's batch
MESH_CARD_CPU_RTOL = 1e-4  # (c): card vs CPU, float32, TF32 off


def _mesh_model(cfg, shape, dev, **kw):
    """``(mesh, model)``: ``cfg`` on a LocalMesh of ``shape`` thread ranks
    (``(data, model)``, or ``(pods, data, model)`` with the batch over pod
    and data) sharing ``dev``, taking turns at host code (a wait past
    MESH_TIMEOUT fails the mesh)."""
    from repro_torch.comm import LocalMesh
    from repro_torch.configs import ShardingConfig
    from repro_torch.models import build_model

    sh = {k: kw.pop(k) for k in ("fsdp", "zero1", "moe_pipeline", "seq_axis", "sp_dim",
                                 "attn_anchor") if k in kw}
    pods, data, model = (1, *shape) if len(shape) == 2 else shape
    mesh = LocalMesh(data, model, pods=pods, device=dev, timeout=MESH_TIMEOUT, turns=True)
    dp = ("data",) if pods == 1 else ("pod", "data")
    return mesh, build_model(cfg, ShardingConfig(batch_axes=dp, **sh), mesh, **kw)


def _spec_elements(model, specs_of=None) -> int:
    """Elements one rank holds of the model's weights (or of the state specs
    ``specs_of``), by the specs' arithmetic."""
    from repro_torch.comm.spec import local_shape
    from repro_torch.models.factory import mesh_axes

    shapes = dict(model.abstract_params().named_parameters())
    specs = specs_of or model.param_specs(shapes)
    sizes = mesh_axes(model.mesh, model.sharding)
    return sum(math.prod(local_shape(t.shape, specs[k], sizes)) for k, t in shapes.items())


def _rank_index(ctx) -> int:
    return (ctx.pod.rank * ctx.iters.size + ctx.iters.rank) * ctx.data.size + ctx.data.rank


def mesh_grads(model, whole, tokens, context=None):
    """The meshed loss and gradients of ``whole``'s weights on ``tokens``
    (global rows; ``context`` their context, if any): each rank's backward
    on its own thread, the gradients summed over the data axis where a
    weight is whole on it and gathered whole; ``(loss, {name: gradient})``
    on the CPU, from rank (0, 0)."""
    import torch
    from repro_torch.comm.spec import gather_whole, used_axes

    def rank(ctx):
        p = model.shard_params(whole)
        b = tokens.shape[0] // ctx.data.size
        lo, hi = ctx.data.rank * b, (ctx.data.rank + 1) * b
        batch = {"tokens": tokens[lo:hi]}
        if context is not None:
            batch["context"] = context[lo:hi]
        specs = model.param_specs(p)
        groups = {"data": ctx.data, "model": ctx.model}
        p.requires_grad_(True)
        with torch.autograd.set_multithreading_enabled(False):
            loss = model.loss_fn(p, batch)
            grads = torch.autograd.grad(loss, list(p.parameters()))
        out = {}
        for (k, _), g in zip(p.named_parameters(), grads):
            if "data" not in used_axes(specs[k]) and ctx.data.size > 1:
                g = ctx.data.all_reduce_sum(g)
            g = gather_whole(g, specs[k], groups)
            if _rank_index(ctx) == 0:
                out[k] = g.cpu()
        return loss.item(), out

    return mesh_run(model.mesh, rank)[0]


def mesh_run(mesh, fn):
    """``mesh.run(fn)`` with the card synchronized after it."""
    import torch

    out = mesh.run(fn)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    return out


def _leaf_errs(got, want):
    """Per gradient leaf ``max |got - want| / max |want|``."""
    out = {}
    for k, w in want.items():
        den = w.abs().max().item()
        e = (got[k].to(w.device) - w).abs().max().item()
        out[k] = e / den if den else float(e != 0)
    return out


def mesh_train(dev, single_losses, label="phase 18 (a)", warm=TRAIN_WARM, timed=MESH_TRAIN_TIMED,
               against="phase 17 (a)", f32_check=True, shape=MESH_TRAIN, fsdp=True,
               **sharding):
    """(a) smollm-360m whole on LocalMesh 2 x 2 (FSDP and ZeRO-1), bf16,
    B = 8 x 2048 of the stream, phase 17 (a)'s weights, lr and schedule:
    TRAIN_WARM + MESH_TRAIN_TIMED steps, whose losses track phase 17 (a)'s within
    MESH_TRAIN_RTOL relative; each rank's weight, gradient, ``m`` and ``v``
    elements == the specs' arithmetic; ms a step, tokens/s, peak bytes, the
    last warm step under the profiler (busy share).  Then the float32 check at
    MESH_F32_LAYERS layers: the meshed loss and gradients == one device's.
    Phase 20 (b) runs it again on its ``shape`` (pods, data, model) with
    the production sharding (``fsdp``, ``sharding``: sequence parallelism)
    for ``warm`` + ``timed`` steps under its ``label``, without the float32
    check (``f32_check``: its reduced card-vs-CPU run holds the same path).
    The record carries what the process held before (``held_bytes``) and
    the whole weights' bytes, for phase 20 (a)'s memory model."""
    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train import DataConfig, make_train_step, synthetic_batch
    from repro_torch.train.train_loop import rank_opt_state

    cfg = get_arch(TRAIN_ARCH)
    mesh, model = _mesh_model(cfg, shape, dev, fsdp=fsdp, zero1=True, **sharding)
    data = DataConfig(cfg.vocab_size, TRAIN_BATCH, TRAIN_LEN, seed=0)
    step, shardings = make_train_step(model, train_tcfg(), mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = torch.cuda.memory_allocated(dev)
    before = read_launches()
    t0 = time.perf_counter()
    whole = [model.init_fn(torch.Generator(device=dev).manual_seed(0))]  # train()'s weights
    whole_bytes = sum(p.numel() * p.element_size() for p in whole[0].parameters())
    state, stamps = {}, []

    def setup(ctx):
        p = model.shard_params(whole[0])
        ctx.data.barrier()
        ctx.model.barrier()
        if _rank_index(ctx) == 0:
            whole.clear()
        o = rank_opt_state(model, p)
        state[_rank_index(ctx)] = [p, o]
        return (sum(t.numel() for t in p.parameters()),
                sum(t.numel() for t in o["m"].values()), sum(t.numel() for t in o["v"].values()))

    counts = mesh_run(mesh, setup)
    init_s = time.perf_counter() - t0
    want_w, want_m = _spec_elements(model), _spec_elements(model, shardings["opt"]["m"])
    if set(counts) != {(want_w, want_m, want_m)}:
        raise AssertionError(f"{label}: rank elements (weights, m, v) {counts}, the specs "
                             f"give {(want_w, want_m, want_m)}")

    def steps(first, n):
        def fn(ctx):
            p, o = state[_rank_index(ctx)]
            losses = []
            for i in range(first, first + n):
                p, o, m = step(p, o, synthetic_batch(data, i, dev))
                losses.append(float(m["loss"]))
                if _rank_index(ctx) == 0:
                    stamps.append(time.perf_counter())
            state[_rank_index(ctx)] = [p, o]
            return losses
        return fn

    nsteps = warm + timed
    # the warm steps, the last under the profiler (its busy share), then
    # the timed ones
    losses = mesh_run(mesh, steps(0, warm - 1))[0]
    split = device_split(lambda: losses.extend(mesh_run(mesh, steps(warm - 1, 1))[0]),
                         host_ops=False)
    stamps[:] = [time.perf_counter()]
    losses += mesh_run(mesh, steps(warm, timed))[0]
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    peak = torch.cuda.max_memory_allocated(dev)
    launched = {k: v - before[k] for k, v in read_launches().items()}
    grads_elems = sum(p.numel() for p in state[0][0].parameters())  # a gradient per weight
    state.clear()
    torch.cuda.empty_cache()
    errs = [abs(a - b) / abs(b) for a, b in zip(losses, single_losses[:nsteps])]
    if not (all(math.isfinite(x) for x in losses) and max(errs) <= MESH_TRAIN_RTOL):
        raise AssertionError(f"{label}: meshed losses {losses} against {against}'s "
                             f"{single_losses[:nsteps]} (relative {errs})")
    if any(launched.values()) or not split["device_busy_ms"]:
        raise AssertionError(f"{label}: launches {launched}, profiled {split}")
    ms = sum(step_s) / len(step_s) * 1e3
    tokens = TRAIN_BATCH * TRAIN_LEN
    state_bytes = 4 * (want_w + grads_elems + 2 * want_m)
    log(f"{label} {TRAIN_ARCH} on LocalMesh {' x '.join(map(str, shape))} ({'FSDP, ' * fsdp}"
        f"ZeRO-1{''.join(f', {k}={v}' for k, v in sharding.items())}), B={TRAIN_BATCH} "
        f"L={TRAIN_LEN}: {ms:.1f} ms a step over {len(step_s)} "
        f"{[round(x * 1e3, 1) for x in step_s]}, {tokens / ms * 1e3:.0f} tokens/s, peak "
        f"{peak / 2 ** 30:.2f} GiB; a rank holds {want_w} weight, {grads_elems} gradient and "
        f"{want_m} m / v elements ({state_bytes / 1e9:.3f} GB float32); losses {losses} vs "
        f"{against} within {max(errs):.3g}; profiled step {split}; setup {init_s:.1f}s")
    record = dict(arch=TRAIN_ARCH, mesh=list(shape), fsdp=fsdp, zero1=True, **sharding,
                  batch=TRAIN_BATCH, seq_len=TRAIN_LEN, ms_per_step=ms,
                  step_ms_runs=[x * 1e3 for x in step_s], tokens_per_s=tokens / ms * 1e3,
                  peak_bytes=peak, losses=losses, single_device_losses=single_losses[:nsteps],
                  loss_rel_err_max=max(errs),
                  rank_elements={"weights": want_w, "gradients": grads_elems, "m": want_m,
                                 "v": want_m}, rank_state_bytes=state_bytes,
                  profiled_step=split, setup_seconds=init_s, launches=launched,
                  held_bytes=held, whole_weight_bytes=whole_bytes)
    if not f32_check:
        return record
    # float32 at MESH_F32_LAYERS layers: meshed loss and gradients == one device's
    cfg2 = dataclasses.replace(cfg, num_layers=MESH_F32_LAYERS)
    single = build_model(cfg2, dtype=torch.float32, device=dev)
    _, model2 = _mesh_model(cfg2, MESH_TRAIN, dev, fsdp=True, dtype=torch.float32,
                            **sharding)
    w2 = single.init_fn(torch.Generator(device=dev).manual_seed(4))
    toks = synthetic_batch(data, 0, dev)["tokens"][:MESH_F32_BATCH]
    want_loss, want = _loss_and_grads(single, w2, {"tokens": toks})
    want = {k: v.cpu() for k, v in want.items()}
    w2.requires_grad_(False)
    got_loss, got = mesh_grads(model2, w2, toks)
    gn = lambda g: math.sqrt(sum(float(t.double().square().sum()) for t in g.values()))  # noqa
    loss_err = abs(got_loss - want_loss) / abs(want_loss)
    norm_err = abs(gn(got) - gn(want)) / gn(want)
    errs32 = _leaf_errs(got, want)
    worst = max(errs32, key=errs32.get)
    if not (loss_err <= MESH_F32_LOSS_RTOL and norm_err <= MESH_F32_LOSS_RTOL
            and errs32[worst] <= MESH_F32_GRAD_TOL):
        raise AssertionError(f"{label} float32: loss {loss_err}, norm {norm_err}, "
                             f"{worst} {errs32[worst]}")
    log(f"{label} float32, {MESH_F32_LAYERS} layers, full width, B={MESH_F32_BATCH}: meshed "
        f"loss and gradient norm == one device's within {max(loss_err, norm_err):.3g}, each "
        f"gathered gradient within {errs32[worst]:.3g} of its largest entry ({worst})")
    del w2, got, want
    torch.cuda.empty_cache()
    return record | dict(float32_check={
        "layers": MESH_F32_LAYERS, "batch": MESH_F32_BATCH, "loss_rel_err": loss_err,
        "grad_norm_rel_err": norm_err, "grad_leaf_err_worst": errs32[worst], "worst_leaf": worst})


def mesh_serve(dev, refs):
    """(b) granite-3-8b whole on LocalMesh 1 x 4 (tensor-parallel), phase 8's
    bf16 weights and prompts (B = 4 x 4096): prefill (one warm, LM_TIMED
    timed) and MESH_SERVE_DECODE greedy decode steps on the sequence-sharded bf16
    cache.  Every prefill launches the bf16 flash kernel once a layer a rank
    (on the rank's 8 q and 2 KV heads); one rank's launch == its plain
    version under the flash gate, timed.  The bf16 decode step after phase
    8's first token stays within LM_BF16_RATIO of the bf16 forward's
    distance from phase 8's float32 forward; at MESH_SERVE_F32_LAYERS
    layers, float32 over a float32 cache, the meshed decode step == a
    single-device forward within LM_DECODE_TOL."""
    import torch
    from repro_torch.comm.spec import PartitionSpec as P
    from repro_torch.comm.spec import gather_whole
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.models import build_model
    from repro_torch.models.transformer import forward

    cfg = get_arch(LM_ARCH)
    mesh, model = _mesh_model(cfg, MESH_SERVE, dev, cast_params=True)
    gen = torch.Generator(device=dev)
    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)  # what the process holds beside this cell
    whole = [model.init_fn(gen.manual_seed(0))]  # phase 8's weights
    whole_bytes = sum(p.numel() * p.element_size() for p in whole[0].parameters())
    prompt = torch.randint(0, cfg.vocab_size, (LM_BATCH, LM_LEN), generator=gen.manual_seed(1),
                           device=dev)
    first_tok = refs["first_tok"].to(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    times = {"prefill": [], "decode": []}
    per_prefill = []

    def whole_logits(ctx, lg):
        return gather_whole(lg, P("data", "model"), {"data": ctx.data, "model": ctx.model})

    def rank(ctx):
        p = model.shard_params(whole[0])
        ctx.data.barrier()
        ctx.model.barrier()
        lead = _rank_index(ctx) == 0
        if lead:
            whole.clear()
        n = sum(t.numel() for t in p.parameters())
        nbytes = sum(t.numel() * t.element_size() for t in p.parameters())
        for i in range(1 + LM_TIMED):
            ctx.model.barrier()
            if lead:
                torch.cuda.synchronize(dev)
                before, t = flash_attention.launches_wgmma, time.perf_counter()
            lg, caches = model.prefill_fn(p, {"tokens": prompt})
            ctx.model.barrier()
            if lead:
                torch.cuda.synchronize(dev)
                per_prefill.append(flash_attention.launches_wgmma - before)
                if i:
                    times["prefill"].append(time.perf_counter() - t)
            if i < LM_TIMED:
                del lg, caches
        prefill_logits = whole_logits(ctx, lg)
        tok, steps = first_tok, []
        ctx.model.barrier()
        t = time.perf_counter()
        for i in range(MESH_SERVE_DECODE):
            lg, caches = model.decode_fn(p, {"tokens": tok, "pos": LM_LEN + i, "caches": caches})
            full = whole_logits(ctx, lg)
            if i == 0:
                step0 = full.clone()
            tok = full.argmax(-1, keepdim=True)
            steps.append(bool(torch.isfinite(full).all()))
        torch.cuda.synchronize(dev)
        if lead:
            times["decode"].append((time.perf_counter() - t) / MESH_SERVE_DECODE)
        return n, nbytes, prefill_logits.cpu() if lead else None, step0.cpu() if lead else None, \
            all(steps)

    out = mesh_run(mesh, rank)
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches = read_launches()
    n_rank, bytes_rank, prefill_logits, step0, finite = out[0]
    want_n = _spec_elements(model)
    if {o[0] for o in out} != {want_n}:
        raise AssertionError(f"phase 18 (b): rank weight elements {[o[0] for o in out]}, the "
                             f"specs give {want_n}")
    if not (all(o[4] for o in out) and torch.isfinite(prefill_logits).all()
            and prefill_logits.shape == (LM_BATCH, cfg.padded_vocab)):
        raise AssertionError("phase 18 (b): logits not finite or of the wrong shape")
    want_launches = cfg.num_layers * MESH_SERVE[1]
    if per_prefill != [want_launches] * (1 + LM_TIMED) or launches["flash_attention_fp32"]:
        raise AssertionError(f"phase 18 (b): bf16 flash launches per prefill {per_prefill}, "
                             f"want {want_launches}; path launches {launches}")
    v = cfg.vocab_size
    fwd32 = refs["fwd32"]
    dist = (step0[:, :v] - fwd32).abs().max().item()
    ratio = dist / refs["dist"]["forward_vs_float32_forward"]
    if not ratio <= LM_BF16_RATIO:
        raise AssertionError(f"phase 18 (b): the meshed bf16 decode step 0 is {ratio:.3g}x as "
                             f"far from phase 8's float32 forward as the bf16 forward is")
    prefill_ms = min(times["prefill"]) * 1e3
    decode_ms = times["decode"][0] * 1e3
    torch.cuda.empty_cache()
    # one rank's flash launch at its own shape, against its plain version
    hq, hkv = cfg.num_heads // MESH_SERVE[1], cfg.num_kv_heads // MESH_SERVE[1]
    q, k, vv = (torch.randn(s, generator=gen.manual_seed(6), device=dev).to(torch.bfloat16)
                for s in ((LM_BATCH, hq, LM_LEN, 128), (LM_BATCH, hkv, LM_LEN, 128),
                          (LM_BATCH, hkv, LM_LEN, 128)))
    err = flash_check(q, k, vv, True, 0)
    lib = sdpa(q, k, vv, True)
    flash_row = dict(shape=f"B={LM_BATCH} Hq={hq} Hkv={hkv} L={LM_LEN} D=128 bfloat16 causal",
                     err=err, ms=cuda_ms(lambda: flash_attention(q, k, vv, causal=True), reps=10),
                     plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, vv, causal=True), 1),
                     library_ms=cuda_ms(lib, reps=10), bound=flash_bound(q, k, True, 0))
    del q, k, vv, lib
    log(f"phase 18 (b) {LM_ARCH} on LocalMesh {MESH_SERVE[0]} x {MESH_SERVE[1]}: prefill "
        f"B={LM_BATCH} L={LM_LEN} {[round(t * 1e3, 1) for t in times['prefill']]} ms "
        f"({LM_BATCH * LM_LEN / min(times['prefill']):.0f} tokens/s); decode {decode_ms:.2f} "
        f"ms/step over {MESH_SERVE_DECODE}; peak {peak / 2 ** 30:.2f} GiB; a rank holds "
        f"{n_rank} weight elements ({bytes_rank / 1e9:.2f} GB); wgmma flash launches per prefill {per_prefill}; "
        f"bf16 decode step 0 {ratio:.3g}x the bf16 forward's distance from float32 ({dist:.3g}); "
        f"a rank's flash launch {flash_row['shape']}: {flash_row['ms']:.3f} ms (plain "
        f"{flash_row['plain_ms']:.2f}, sdpa {flash_row['library_ms']:.3f}, bound "
        f"{flash_row['bound'][0]:.4f}), max_abs_err {err:.3g}; {run_s:.1f}s")
    # float32 at MESH_SERVE_F32_LAYERS layers over a float32 cache
    reset_launches()
    cfg4 = dataclasses.replace(cfg, num_layers=MESH_SERVE_F32_LAYERS)
    single = build_model(cfg4, dtype=torch.float32, device=dev)
    mesh4, model4 = _mesh_model(cfg4, MESH_SERVE, dev, dtype=torch.float32,
                                cache_dtype=torch.float32)
    w4 = single.init_fn(gen.manual_seed(2))

    def rank32(ctx):
        p = model4.shard_params(w4)
        lg, caches = model4.prefill_fn(p, {"tokens": prompt})
        tok = whole_logits(ctx, lg).argmax(-1, keepdim=True)
        lg, _ = model4.decode_fn(p, {"tokens": tok, "pos": LM_LEN, "caches": caches})
        return tok, whole_logits(ctx, lg)

    tok, dec32 = mesh_run(mesh4, rank32)[0]
    f32_launches = read_launches()
    full, _, _ = forward(w4, cfg4, torch.cat([prompt, tok], 1), mode="train",
                         dtype=torch.float32)
    fwd = full[:, -1]
    del full, w4
    dec_err = (dec32[:, :v] - fwd[:, :v]).abs().max().item()
    if not torch.allclose(dec32, fwd, rtol=LM_DECODE_TOL, atol=LM_DECODE_TOL):
        raise AssertionError(f"phase 18 (b): float32 meshed decode vs forward at "
                             f"{MESH_SERVE_F32_LAYERS} layers: max abs err {dec_err}")
    if f32_launches["flash_attention_fp32"] != MESH_SERVE_F32_LAYERS * MESH_SERVE[1] or \
            f32_launches["flash_attention"]:
        raise AssertionError(f"phase 18 (b) float32 checks: launches {f32_launches}")
    log(f"phase 18 (b) float32, {MESH_SERVE_F32_LAYERS} layers, float32 cache: meshed decode "
        f"step == forward over {LM_LEN + 1} tokens within {LM_DECODE_TOL} (max abs err "
        f"{dec_err:.3g}); float32 flash launches {f32_launches['flash_attention_fp32']}")
    torch.cuda.empty_cache()
    return dict(arch=LM_ARCH, mesh=list(MESH_SERVE), batch=LM_BATCH, prompt_len=LM_LEN,
                decode_steps=MESH_SERVE_DECODE, prefill_ms=prefill_ms,
                prefill_ms_runs=[t * 1e3 for t in times["prefill"]],
                tokens_per_s=LM_BATCH * LM_LEN / min(times["prefill"]),
                decode_ms_per_step=decode_ms, peak_bytes=peak, rank_weight_elements=n_rank,
                rank_weight_bytes=bytes_rank, flash_launches_per_prefill=per_prefill[0],
                bf16_decode_step0_distance=dist, bf16_over_forward_distance=ratio,
                float32_check={"layers": MESH_SERVE_F32_LAYERS, "max_abs_err": dec_err},
                rank_flash_launch=flash_row, seconds=run_s, held_bytes=held,
                whole_weight_bytes=whole_bytes, launches=launches,
                float32_check_launches=f32_launches)


def mesh_moe(dev):
    """(c) phi3.5-moe at full width cut to one layer on LocalMesh 2 x 2 (FSDP,
    experts over the model axis), bf16, B = 4 x 2048, fused and pipelined
    (``grouped_exchange``): each rank holds its specs' share of every expert
    weight; every expert-layer call's aux finite and positive, finite
    losses; ms a step (after the first) and peak bytes.  Then the six mesh
    rows' reduced configs, float32, on 2 x 2: the loss and every gathered
    gradient on the card == the meshed CPU run's within MESH_CARD_CPU_RTOL."""
    import torch
    from repro_torch.comm.spec import local_shape
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model, transformer
    from repro_torch.models.factory import mesh_axes
    from repro_torch.train import (AdamWConfig, DataConfig, TrainConfig, make_train_step,
                                   synthetic_batch)
    from repro_torch.train.train_loop import rank_opt_state

    name, layers, b, l, nsteps = MESH_MOE
    cfg = dataclasses.replace(get_arch(name), num_layers=layers)
    data = DataConfig(cfg.vocab_size, b, l, seed=1)
    auxes, real = [], transformer.moe_block_manual

    def spy(*args, **kwargs):
        out, aux = real(*args, **kwargs)
        auxes.append(float(aux.detach()))
        return out, aux

    modes = {}
    before = read_launches()
    transformer.moe_block_manual = spy
    try:
        for mode, pipeline in (("fused", False), ("pipelined", True)):
            mesh, model = _mesh_model(cfg, MESH_TRAIN, dev, fsdp=True, moe_pipeline=pipeline)
            step, shardings = make_train_step(
                model, TrainConfig(opt=AdamWConfig(total_steps=nsteps, **TRAIN_OPT)), mesh)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            whole = [model.init_fn(torch.Generator(device=dev).manual_seed(17))]
            sizes = mesh_axes(mesh, model.sharding)
            times, shares = [], []

            def rank(ctx):
                p = model.shard_params(whole[0])
                ctx.data.barrier()
                ctx.model.barrier()
                lead = _rank_index(ctx) == 0
                if lead:
                    whole.clear()
                for k, t in p.named_parameters():
                    if ".ffn." in k:
                        full = dict(model.abstract_params().named_parameters())[k].shape
                        if tuple(t.shape) != local_shape(full, shardings["params"][k], sizes):
                            raise AssertionError(f"phase 18 (c): {k} {tuple(t.shape)}")
                        if lead:
                            shares.append((k, tuple(t.shape)))
                o = rank_opt_state(model, p)
                losses = []
                for i in range(nsteps):
                    t = time.perf_counter()
                    p, o, m = step(p, o, synthetic_batch(data, i, dev))
                    losses.append(float(m["loss"]))
                    if lead:
                        times.append(time.perf_counter() - t)
                return losses

            losses = mesh_run(mesh, rank)[0]
            peak = torch.cuda.max_memory_allocated(dev)
            if not all(math.isfinite(x) for x in losses):
                raise AssertionError(f"phase 18 (c) {mode}: losses {losses}")
            modes[mode] = dict(ms_per_step=sum(times[1:]) / len(times[1:]) * 1e3,
                               step_ms_runs=[t * 1e3 for t in times], peak_bytes=peak,
                               losses=losses, expert_shares=dict(shares))
            del model, step
            torch.cuda.empty_cache()
    finally:
        transformer.moe_block_manual = real
    launched = {k: v - before[k] for k, v in read_launches().items()}
    if not (auxes and all(math.isfinite(a) and a > 0 for a in auxes)) or any(launched.values()):
        raise AssertionError(f"phase 18 (c): aux {auxes}, launches {launched}")
    log(f"phase 18 (c) {name} (1 layer, full width) on LocalMesh {MESH_TRAIN[0]} x "
        f"{MESH_TRAIN[1]}, FSDP, EP, B={b} L={l}: "
        + "; ".join(f"{m} {r['ms_per_step']:.1f} ms a step "
                    f"{[round(t, 1) for t in r['step_ms_runs']]}, peak "
                    f"{r['peak_bytes'] / 2 ** 30:.2f} GiB, losses {r['losses']}"
                    for m, r in modes.items())
        + f"; a rank's experts {modes['fused']['expert_shares']}; aux per call "
        f"{[round(a, 4) for a in auxes]}")
    # the six mesh rows, reduced, float32: card == CPU on the same mesh
    rows = {}
    b_rows, l_rows = MESH_ROWS_SHAPE
    for i, row in enumerate(MESH_ROWS):
        rcfg = get_arch(row).reduced()
        w = build_model(rcfg, dtype=torch.float32, device="cpu").init_fn(
            torch.Generator().manual_seed(i))
        toks = synthetic_batch(DataConfig(rcfg.vocab_size, b_rows, l_rows, seed=i), 0,
                               "cpu")["tokens"]
        _, m_cpu = _mesh_model(rcfg, MESH_TRAIN, "cpu", fsdp=True, dtype=torch.float32)
        want_loss, want = mesh_grads(m_cpu, w, toks)
        _, m_card = _mesh_model(rcfg, MESH_TRAIN, dev, fsdp=True, dtype=torch.float32)
        import copy

        got_loss, got = mesh_grads(m_card, copy.deepcopy(w).to(dev), toks.to(dev))
        errs = _leaf_errs(got, want)
        worst = max(errs, key=errs.get)
        loss_err = abs(got_loss - want_loss) / abs(want_loss)
        rows[row] = dict(loss_rel_err=loss_err, grad_leaf_err_worst=errs[worst], worst_leaf=worst)
        if not (loss_err <= MESH_CARD_CPU_RTOL and errs[worst] <= MESH_CARD_CPU_RTOL):
            raise AssertionError(f"phase 18 (c) {row}: card vs CPU loss {loss_err}, {worst} "
                                 f"{errs[worst]}")
    log("phase 18 (c) the six mesh rows, reduced, float32 on 2 x 2: card == CPU (loss / worst "
        "gradient leaf, relative): " + ", ".join(
            f"{k} {v['loss_rel_err']:.2g}/{v['grad_leaf_err_worst']:.2g}" for k, v in rows.items()))
    return dict(arch=name, layers=layers, batch=b, seq_len=l, steps=nsteps, modes=modes,
                aux=auxes, launches=launched, card_vs_cpu=rows)


_DIST_CHILD = """
import json, sys
import torch
sys.path.insert(0, sys.argv[2])
torch.use_deterministic_algorithms(True, warn_only=True)
torch.backends.cuda.matmul.allow_tf32 = False
from repro_torch.configs import ShardingConfig, get_arch
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import build_model
from repro_torch.train import AdamWConfig, TrainConfig, train

steps = int(sys.argv[3])
if sys.argv[1] == "torchrun":
    out = launch_train.main(["--arch", "smollm-360m", "--steps", str(steps), "--distributed"])
else:
    mesh = make_local_mesh(1, 1)
    model = build_model(get_arch("smollm-360m").reduced(), ShardingConfig(batch_axes=("data",)),
                        mesh)
    out = train(model, TrainConfig(steps=steps, opt=AdamWConfig(total_steps=steps)), mesh)
if out is not None:
    weights = sum(float(p.double().sum()) for p in out["params"].parameters())
    print("RESULT " + json.dumps([float(out["metrics"]["loss"]),
                                  float(out["metrics"]["grad_norm"]), weights]))
"""
MESH_DIST_STEPS = 2  # (d)


def mesh_distributed():
    """(d) ``launch/train.py --distributed`` under torchrun at world size 1
    (NCCL; smollm-360m reduced, MESH_DIST_STEPS steps) and the same training
    on a 1 x 1 LocalMesh, each a fresh process with deterministic algorithms
    on: the final loss, gradient norm and the weights' sum equal, bitwise."""
    with tempfile.TemporaryDirectory(prefix=".smoke_tmp", dir=ROOT) as tmp:
        script = Path(tmp) / "dist_child.py"
        script.write_text(_DIST_CHILD)
        src = str(ROOT / "src")
        t0 = time.perf_counter()
        procs = {
            "torchrun": subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "1",
                 "--master-addr", "localhost", "--master-port", str(_free_port()), str(script),
                 "torchrun", src, str(MESH_DIST_STEPS)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=tmp),
            "local": subprocess.Popen([sys.executable, str(script), "local", src,
                                       str(MESH_DIST_STEPS)], stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True, cwd=tmp)}
        got = {}
        for k, proc in procs.items():
            try:
                out, err = proc.communicate(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
            lines = [x for x in out.splitlines() if x.startswith("RESULT ")]
            if proc.returncode or len(lines) != 1:
                raise AssertionError(f"phase 18 (d) {k}: exit {proc.returncode}; {err[-2000:]}")
            got[k] = json.loads(lines[0][7:])
        secs = time.perf_counter() - t0
    if got["torchrun"] != got["local"]:
        raise AssertionError(f"phase 18 (d): torchrun {got['torchrun']} != LocalMesh 1 x 1 "
                             f"{got['local']}")
    log(f"phase 18 (d) --distributed under torchrun at world size 1 (NCCL), "
        f"{MESH_DIST_STEPS} steps: (loss, gradient norm, sum of the weights) {got['torchrun']} "
        f"== LocalMesh 1 x 1, bitwise ({secs:.1f}s, both processes)")
    return dict(steps=MESH_DIST_STEPS, torchrun=got["torchrun"], local_mesh=got["local"],
                bitwise=True, seconds=secs)


def phase_mesh(dev, single_losses, lm_refs):
    """Phase 18: the LM on a mesh, (a)-(d); the meshed prefill launches the
    bf16 flash kernel on each rank's heads (path "lm_mesh"; its float32
    checks "lm_mesh_float32_checks"), training none."""
    import torch

    torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    out, part_s = {}, {}
    for part, run in (("train", lambda: mesh_train(dev, single_losses)),
                      ("serve", lambda: mesh_serve(dev, lm_refs)),
                      ("moe", lambda: mesh_moe(dev)),
                      ("distributed", mesh_distributed)):
        t0 = time.perf_counter()
        out[part] = run()
        part_s[part] = time.perf_counter() - t0
    out["part_seconds"] = part_s
    out["seconds"] = dt = time.perf_counter() - t_start
    log(f"phase 18 passed in {dt:.1f}s ({', '.join(f'{k} {v:.1f}s' for k, v in part_s.items())})")
    serve = out["serve"]
    return (serve.pop("launches"), serve.pop("float32_check_launches"), serve["rank_flash_launch"],
            out)


# ---------------------------------------------------------------------------
# phase 19: the four other rows on a mesh, sequence parallelism and anchors
# ---------------------------------------------------------------------------

#: (a)-(c): row -> (mesh, layers kept or None for full depth, prompts, tokens a
#: prompt, ShardingConfig fields); widths never cut
MESH_ROWS_SERVE = {
    "recurrentgemma-2b": ((2, 2), None, 2, 4096, {"attn_anchor": True}),  # (a)
    "rwkv6-3b": ((1, 4), 16, 4, 4096, {}),  # (b): half its 32 layers, for the script's time
    "llama-3.2-vision-90b": ((1, 4), 5, 2, 4096, {}),  # (c): one pattern group
    "whisper-base": ((1, 4), None, 4, 448, {}),  # (c)
}
MESH_ROWS_TIMED = 1  # (a)-(c): timed prefills after a warm one
MESH_ROWS_DECODE = 16  # (a)-(c): greedy decode steps (cut from 32 for the script's time)
MESH_SP = {"seq_axis": "model"}  # sequence parallelism (smollm-360m's reduced check)
#: every row's reduced config, float32, card == the CPU's meshed run: (mesh,
#: ShardingConfig fields)
MESH_ROWS_REDUCED = {
    "recurrentgemma-2b": ((2, 2), {"attn_anchor": True}),
    "rwkv6-3b": ((1, 4), {}),
    "llama-3.2-vision-90b": ((1, 4), {}),
    "whisper-base": ((1, 4), {}),
    "smollm-360m": ((2, 2), dict(MESH_SP, fsdp=True)),
}


def mesh_row_cfg(name: str):
    from repro_torch.configs import get_arch

    cfg = get_arch(name)
    layers = MESH_ROWS_SERVE[name][1]
    return cfg if layers is None else dataclasses.replace(cfg, num_layers=layers)


def mesh_row_flash_shapes(cfg, shape, batch: int, length: int, anchor: bool):
    """Each flash launch shape of a rank's prefill: ``((B, Hq, Hkv, L, D),
    causal, window)``: whole heads, the rank's share of q and KV heads;
    anchored (the heads divide the model axis, the KV heads do not), the
    rank's q heads over the KV heads they read, each once where they serve
    them in equal groups (as ``attention_block_tp`` gives them); cut, every
    head."""
    from repro_torch.models.transformer import layer_kinds

    (data, pm), d = shape, cfg.resolved_head_dim
    h, kv = cfg.num_heads, cfg.num_kv_heads
    heads = set()
    for m in range(pm):
        if h % pm == 0 and kv % pm == 0:
            heads.add((h // pm, kv // pm))
        elif anchor and h % pm == 0:
            hq = h // pm
            idx = [(m * hq + j) // (h // kv) for j in range(hq)]
            n = idx[-1] - idx[0] + 1
            whole_groups = hq % n == 0 and idx == [idx[0] + j // (hq // n) for j in range(hq)]
            heads.add((hq, n if whole_groups else hq))
        else:
            heads.add((h, kv))
    out = []
    for hq, hkv in sorted(heads):
        for kind in dict.fromkeys(layer_kinds(cfg)):
            if kind in ("attn", "local", "attn_cross"):
                window = cfg.local_window if kind == "local" else cfg.window
                out.append(((batch // data, hq, hkv, length, d), True, window))
        if cfg.encoder_layers:
            out.append(((batch // data, hq, hkv, cfg.encoder_context, d), False, 0))
    return out


def _spy_flash():
    """Record the q and k shapes of every ``ops.flash_attention`` call (the
    path the models take) while the returned list is open; ``close()``
    restores the function."""
    from repro_torch.kernels import ops

    real, seen = ops.flash_attention, []

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), kw.get("causal", True),
                     kw.get("window", 0)))
        return real(q, k, v, **kw)

    ops.flash_attention = spy
    return seen, lambda: setattr(ops, "flash_attention", real)


def mesh_row_decode_check(model, whole, cfg, inputs, dev):
    """On a LM_ROWS_CHECK_LEN-token prompt: the meshed bf16 prefill and one
    decode step, against one device's forward over the prompt and the token
    in bf16 and then (the same weights, in place) float32: the meshed bf16
    step no more than LM_BF16_RATIO times as far from the float32 forward as
    the bf16 forward.  Returns ``(ratio, distances)``; ``whole`` is left in
    float32."""
    import torch
    from repro_torch.comm.spec import PartitionSpec as P
    from repro_torch.comm.spec import gather_whole
    from repro_torch.models.transformer import encode, forward

    n = LM_ROWS_CHECK_LEN
    toks = inputs["tokens"][:, : n + 1]
    ctx_in = inputs.get("context")
    v = cfg.vocab_size

    def rank(ctx):
        p = model.shard_params(whole)
        b = toks.shape[0] // ctx.data.size
        lo, hi = ctx.data.rank * b, (ctx.data.rank + 1) * b
        batch = {"tokens": toks[lo:hi, :n]}
        if ctx_in is not None:
            batch["context"] = ctx_in[lo:hi]
        _, caches = model.prefill_fn(p, batch)
        lg, _ = model.decode_fn(p, {"tokens": toks[lo:hi, n:], "pos": n, "caches": caches})
        return gather_whole(lg, P("data", "model"), {"data": ctx.data, "model": ctx.model})

    dec16 = mesh_run(model.mesh, rank)[0][:, :v]

    def fwd(dtype):
        ctx = None
        if ctx_in is not None:
            ctx = encode(whole, cfg, ctx_in, dtype=dtype) if cfg.family == "audio" \
                else ctx_in.to(dtype)
        with torch.no_grad():
            full, _, _ = forward(whole, cfg, toks, context=ctx, mode="train", dtype=dtype)
        return full[:, -1, :v].clone()

    fwd16 = fwd(torch.bfloat16)
    whole.float()
    fwd32 = fwd(torch.float32)
    dist = {"decode_vs_float32_forward": (dec16 - fwd32).abs().max().item(),
            "forward_vs_float32_forward": (fwd16 - fwd32).abs().max().item()}
    ratio = dist["decode_vs_float32_forward"] / dist["forward_vs_float32_forward"]
    if not ratio <= LM_BF16_RATIO:
        raise AssertionError(f"phase 19 {cfg.name}: the meshed bf16 decode step is {ratio:.3g}x "
                             f"as far from the float32 forward as the bf16 forward: {dist}")
    return ratio, dist


def mesh_row_serve(name: str, dev, gen):
    """(a)-(c): one row whole (depth cut where MESH_ROWS_SERVE says) on its
    LocalMesh, bf16 weights: each rank holds its specs' share; one warm and
    MESH_ROWS_TIMED timed prefills, MESH_ROWS_DECODE greedy decode steps on the
    rank's caches; every flash launch at the rank's predicted shape and as
    many a prefill as predicted; then the decode check.  Returns the row's
    record, its launches and the flash shapes a rank launched."""
    import torch
    from repro_torch.comm.spec import PartitionSpec as P
    from repro_torch.comm.spec import gather_whole
    from repro_torch.kernels.flash_attention import flash_attention

    cfg = mesh_row_cfg(name)
    shape, _, batch, length, sh = MESH_ROWS_SERVE[name]
    mesh, model = _mesh_model(cfg, shape, dev, cast_params=True, **sh)
    t0 = time.perf_counter()
    whole = model.init_fn(gen)
    draw_gates(whole, gen)
    inputs = lm_row_inputs(cfg, batch, length, gen, dev)
    init_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    before = read_launches()
    times = {"prefill": [], "decode": []}
    per_prefill = []
    seen, restore = _spy_flash()

    def sync(ctx):
        ctx.data.barrier()
        ctx.model.barrier()

    def rank(ctx):
        p = model.shard_params(whole)
        groups = {"data": ctx.data, "model": ctx.model}
        lead = _rank_index(ctx) == 0
        n = sum(t.numel() for t in p.parameters())
        b = batch // ctx.data.size
        lo, hi = ctx.data.rank * b, (ctx.data.rank + 1) * b
        mine = {k: t[lo:hi] for k, t in inputs.items()}
        for i in range(1 + MESH_ROWS_TIMED):
            sync(ctx)
            if lead:
                torch.cuda.synchronize(dev)
                n0, t = flash_attention.launches_wgmma, time.perf_counter()
            sync(ctx)  # no rank launches before the count is read
            lg, caches = model.prefill_fn(p, mine)
            sync(ctx)
            if lead:
                torch.cuda.synchronize(dev)
                per_prefill.append(flash_attention.launches_wgmma - n0)
                if i:
                    times["prefill"].append(time.perf_counter() - t)
            if i < MESH_ROWS_TIMED:
                del lg, caches
        first = gather_whole(lg, P("data", "model"), groups)
        tok, finite = first[lo:hi].argmax(-1, keepdim=True), bool(torch.isfinite(first).all())
        sync(ctx)
        t = time.perf_counter()
        for i in range(MESH_ROWS_DECODE):
            lg, caches = model.decode_fn(p, {"tokens": tok, "pos": length + i, "caches": caches})
            full = gather_whole(lg, P("data", "model"), groups)
            finite &= bool(torch.isfinite(full).all())
            tok = full[lo:hi].argmax(-1, keepdim=True)
        torch.cuda.synchronize(dev)
        if lead:
            times["decode"].append((time.perf_counter() - t) / MESH_ROWS_DECODE)
        return n, tuple(first.shape), finite

    try:
        out = mesh_run(mesh, rank)
    finally:
        restore()
    run_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    served = {k: v - before[k] for k, v in read_launches().items()}
    want_n = _spec_elements(model)
    if {o[0] for o in out} != {want_n}:
        raise AssertionError(f"phase 19 {name}: rank weight elements {[o[0] for o in out]}, the "
                             f"specs give {want_n}")
    if not all(o[2] and o[1] == (batch, cfg.padded_vocab) for o in out):
        raise AssertionError(f"phase 19 {name}: logits not finite or of the wrong shape: "
                             f"{[o[1:] for o in out]}")
    rank_shapes = mesh_row_flash_shapes(cfg, shape, batch, length, sh.get("attn_anchor", False))
    want_per = flash_layers(cfg) * shape[0] * shape[1]
    got_shapes = {(q, k[1], c, w) for q, k, c, w in seen}
    want_shapes = {((b, hq, l, d), hkv, c, w) for (b, hq, hkv, l, d), c, w in rank_shapes}
    if per_prefill != [want_per] * (1 + MESH_ROWS_TIMED) or served["flash_attention_fp32"] \
            or got_shapes != want_shapes:
        raise AssertionError(f"phase 19 {name}: bf16 flash launches per prefill {per_prefill}, "
                             f"want {want_per}; shapes (q, KV heads) {sorted(got_shapes)}, want "
                             f"{sorted(want_shapes)}; launches {served}")
    before = read_launches()
    ratio, dist = mesh_row_decode_check(model, whole, cfg, inputs, dev)
    checks = {k: v - before[k] for k, v in read_launches().items()}
    del whole, inputs
    torch.cuda.empty_cache()
    prefill_ms = min(times["prefill"]) * 1e3
    decode_ms = times["decode"][0] * 1e3
    log(f"phase 19 {name} ({cfg.num_layers} layers) on LocalMesh {shape[0]} x {shape[1]} {sh}: "
        f"prefill B={batch} L={length} {[round(t * 1e3, 1) for t in times['prefill']]} ms "
        f"({batch * length / min(times['prefill']):.0f} tokens/s); decode {decode_ms:.2f} ms/step "
        f"over {MESH_ROWS_DECODE}; peak {peak / 2 ** 30:.2f} GiB; a rank holds {want_n} weight "
        f"elements; "
        f"wgmma flash launches per prefill {per_prefill} at a rank's {sorted(got_shapes)}; bf16 "
        f"decode step {ratio:.3g}x the bf16 forward's distance from float32 ({dist}); "
        f"{run_s:.1f}s")
    return dict(mesh=list(shape), sharding=sh, layers=cfg.num_layers, batch=batch,
                prompt_len=length, decode_steps=MESH_ROWS_DECODE, prefill_ms=prefill_ms,
                prefill_ms_runs=[t * 1e3 for t in times["prefill"]],
                tokens_per_s=batch * length / min(times["prefill"]), decode_ms_per_step=decode_ms,
                peak_bytes=peak, rank_weight_elements=want_n, init_seconds=init_s,
                flash_launches_per_prefill=per_prefill[0],
                rank_flash_shapes=[[list(q), c, w] for q, c, w in rank_shapes],
                bf16_over_forward_distance=ratio, bf16_distances=dist,
                seconds=run_s), served, checks, rank_shapes


def mesh_rows_card_vs_cpu(dev):
    """Every MESH_ROWS_REDUCED row's reduced config in float32 on its mesh and
    settings: the loss and every gathered gradient on the card == the meshed
    CPU run's within MESH_CARD_CPU_RTOL (the train path: no kernel)."""
    import copy

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.models.factory import context_len
    from repro_torch.train import DataConfig, synthetic_batch

    rows = {}
    b_rows, l_rows = MESH_ROWS_SHAPE
    for i, (row, (shape, sh)) in enumerate(MESH_ROWS_REDUCED.items()):
        rcfg = get_arch(row).reduced()
        gen = torch.Generator().manual_seed(50 + i)
        w = build_model(rcfg, dtype=torch.float32, device="cpu").init_fn(gen)
        draw_gates(w, gen)
        toks = synthetic_batch(DataConfig(rcfg.vocab_size, b_rows, l_rows, seed=i), 0,
                               "cpu")["tokens"]
        lc, needed = context_len(rcfg)
        ctx = torch.randn((b_rows, lc, rcfg.d_model), generator=gen) * 0.1 if needed else None
        _, m_cpu = _mesh_model(rcfg, shape, "cpu", dtype=torch.float32, **sh)
        want_loss, want = mesh_grads(m_cpu, w, toks, ctx)
        _, m_card = _mesh_model(rcfg, shape, dev, dtype=torch.float32, **sh)
        got_loss, got = mesh_grads(m_card, copy.deepcopy(w).to(dev), toks.to(dev),
                                   None if ctx is None else ctx.to(dev))
        errs = _leaf_errs(got, want)
        worst = max(errs, key=errs.get)
        loss_err = abs(got_loss - want_loss) / abs(want_loss)
        rows[row] = dict(mesh=list(shape), sharding=sh, loss_rel_err=loss_err,
                         grad_leaf_err_worst=errs[worst], worst_leaf=worst)
        if not (loss_err <= MESH_CARD_CPU_RTOL and errs[worst] <= MESH_CARD_CPU_RTOL):
            raise AssertionError(f"phase 19 {row}: card vs CPU loss {loss_err}, {worst} "
                                 f"{errs[worst]}")
    log("phase 19 reduced rows, float32, on their meshes: card == CPU (loss / worst gradient "
        "leaf, relative): " + ", ".join(
            f"{k} {v['loss_rel_err']:.2g}/{v['grad_leaf_err_worst']:.2g}" for k, v in rows.items()))
    return rows


def mesh_row_launches(dev, rank_shapes):
    """A rank's bf16 flash launch at each new shape of (a)-(c), against its
    plain version under the flash gate, timed beside its bound and SDPA."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev).manual_seed(19)
    rows = []
    for (b, hq, hkv, l, d), causal, window in rank_shapes:
        q, k, v = (torch.randn(s, generator=gen, device=dev).to(torch.bfloat16)
                   for s in ((b, hq, l, d), (b, hkv, l, d), (b, hkv, l, d)))
        err = flash_check(q, k, v, causal, window)
        lib = sdpa(q, k, v, causal, window)
        rows.append(dict(
            shape=f"B={b} Hq={hq} Hkv={hkv} L={l} D={d} bfloat16 "
                  f"{'causal' if causal else 'bidirectional'}"
                  + (f" window {window}" if window else ""), d=d, err=err,
            ms=cuda_ms(lambda: flash_attention(q, k, v, causal=causal, window=window), reps=10),
            plain_ms=cuda_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                             window=window), 1),
            library_ms=cuda_ms(lib, reps=10), bound=flash_bound(q, k, causal, window)))
        del q, k, v, lib
        r = rows[-1]
        log(f"phase 19 a rank's flash launch {r['shape']}: {r['ms']:.3f} ms (plain "
            f"{r['plain_ms']:.2f}, sdpa {r['library_ms']:.3f}, bound {r['bound'][0]:.4f}), "
            f"max_abs_err {err:.3g}")
    torch.cuda.empty_cache()
    return rows


def phase_mesh_rows(dev):
    """Phase 19: (a)-(c) the four other rows served on their meshes, each
    reduced row card == CPU, and a rank's launch at each new flash shape.
    The served launches are path "lm_mesh_rows", the decode checks'
    "lm_mesh_rows_checks".  (Its former (d), smollm-360m on 2 x 2 with
    sequence parallelism, is phase 20 (b) on the pod mesh.)"""
    import torch

    torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    gen = torch.Generator(device=dev)
    rows, served, checks, shapes, part_s = {}, {}, {}, [], {}
    for i, name in enumerate(MESH_ROWS_SERVE):
        t0 = time.perf_counter()
        gen.manual_seed(300 + i)
        rows[name], s, c, rs = mesh_row_serve(name, dev, gen)
        shapes += [x for x in rs if x not in shapes]
        for acc, d in ((served, s), (checks, c)):
            for k, v in d.items():
                acc[k] = acc.get(k, 0) + v
        if name == "recurrentgemma-2b":  # its launches are the D = 256 ones
            d256 = s["flash_attention"]
        part_s[name] = time.perf_counter() - t0
    t0 = time.perf_counter()
    card_cpu = mesh_rows_card_vs_cpu(dev)
    part_s["card_vs_cpu"] = time.perf_counter() - t0
    launch_rows = mesh_row_launches(dev, shapes)
    dt = time.perf_counter() - t_start
    log(f"phase 19 passed in {dt:.1f}s ({', '.join(f'{k} {v:.1f}s' for k, v in part_s.items())}); "
        f"launches served {served}, checks {checks}")
    return served, checks, d256, launch_rows, {"rows": rows, "card_vs_cpu": card_cpu,
                                               "part_seconds": part_s, "seconds": dt}


# ---------------------------------------------------------------------------
# phase 20: the production and multi-pod meshes
# ---------------------------------------------------------------------------

POD_TRAIN = (2, 1, 2)  # (b): pods, data, model
POD_WARM, POD_TIMED = 2, 1  # (b): steps (timed cut from 2 for the script's time)
POD_ROWS_MESH = (2, 2, 2)  # (c): pods, data, model
POD_ROWS_SHAPE = (4, 64)  # (c): each reduced row's batch
POD_ROWS_PREFILL = 60  # (c): prompt tokens; decode takes the rest one at a time
POD_ROWS_TOL = 1e-4  # (c): card vs CPU, float32, TF32 off, relative to the largest entry
DRYRUN_ONE_RANK_RTOL = 0.05  # (a): a one-rank cell, as phase 15 (b) holds NCCL at world size 1

#: (a): the cells phases 8, 17 (a), 18 (a), (b) and 20 (b) run, as the LM
#: dry-run takes them: row, (pods, data, model) or None (one
#: device), ShardingConfig fields, cast weights, kind, batch, tokens
POD_DRYRUN_CELLS = {
    "phase 8 prefill": (LM_ARCH, None, {}, True, "prefill", LM_BATCH, LM_LEN),
    "phase 8 decode": (LM_ARCH, None, {}, True, "decode", LM_BATCH, LM_LEN),
    "phase 17 (a)": (TRAIN_ARCH, None, {}, False, "train", TRAIN_BATCH, TRAIN_LEN),
    "phase 18 (a)": (TRAIN_ARCH, (1, *MESH_TRAIN), {"batch_axes": ["data"], "fsdp": True},
                     False, "train", TRAIN_BATCH, TRAIN_LEN),
    "phase 18 (b) prefill": (LM_ARCH, (1, *MESH_SERVE), {"batch_axes": ["data"]}, True,
                             "prefill", LM_BATCH, LM_LEN),
    "phase 18 (b) decode": (LM_ARCH, (1, *MESH_SERVE), {"batch_axes": ["data"]}, True,
                            "decode", LM_BATCH, LM_LEN),
    "phase 20 (b)": (TRAIN_ARCH, POD_TRAIN, {"batch_axes": ["pod", "data"],
                                             "seq_axis": "model"},
                     False, "train", TRAIN_BATCH, TRAIN_LEN),
}

_LM_DRYRUN_CHILD = """
import json, sys, time
sys.path.insert(0, sys.argv[1])
from repro_torch.comm import AbstractMesh
from repro_torch.configs import ShardingConfig, get_arch
from repro_torch.launch.dryrun import measure_lm
from repro_torch.models import build_model

out = {}
for name, (arch, shape, sh, cast, kind, batch, length) in json.loads(sys.argv[2]).items():
    t0 = time.perf_counter()
    mesh = None if shape is None else AbstractMesh(shape[1], shape[2], pods=shape[0])
    sh = ShardingConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in sh.items()})
    model = build_model(get_arch(arch), sh, mesh, cast_params=cast,
                        device="meta" if mesh is None else None)
    rec = measure_lm(model, kind, batch, length)
    whole = sum(p.numel() * p.element_size() for p in model.abstract_params().parameters())
    out[name] = dict(rec["memory"], whole_weight_bytes=whole, launches=rec["launches"],
                     flops=rec["cost"]["flops"], analysis_s=time.perf_counter() - t0)
print(json.dumps(out))
"""


def start_lm_dryrun():
    """(a)'s dry-run, started with phase 1 in a process that sees no card
    (one thread: it runs beside the phases that use the card)."""
    import os

    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    cells = {k: [*v[:1], None if v[1] is None else list(v[1]), *v[2:]]
             for k, v in POD_DRYRUN_CELLS.items()}
    return subprocess.Popen([sys.executable, "-c", _LM_DRYRUN_CHILD, str(ROOT / "src"),
                             json.dumps(cells)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _total(r) -> int:
    return r["argument_bytes"] + r["output_bytes"] + r["temp_bytes"]


def _local_mesh_ends(ranks: int, runs, setup: int):
    """``(lower, upper)`` peaks of a LocalMesh process whose ranks take turns
    (a rank runs host code until it waits for a peer): ``runs`` each a
    rank's dry-run memory (every rank the same), ``setup`` what the ranks
    and the whole weights hold while the ranks cut theirs.  Lower: every
    rank at its fullest wait (``waiting_bytes``) at once, as all reach that
    collective; upper: the others at their fullest waits while one rank
    peaks."""
    lower = max(ranks * (r["argument_bytes"] + r["waiting_bytes"]) for r in runs)
    upper = max(ranks * (r["argument_bytes"] + r["waiting_bytes"]) + _total(r)
                - r["argument_bytes"] - r["waiting_bytes"] for r in runs)
    return max(setup, lower), max(setup, upper)


def pod_dryrun(proc, lm8, train17, mesh18, pod20):
    """(a): the LM dry-run's peaks against the measured ones of phases 8,
    17 (a), 18 (a), (b) and 20 (b): one-rank cells within DRYRUN_ONE_RANK_RTOL,
    LocalMesh cells inside [lower, upper] (:func:`_local_mesh_ends`)
    widened by MODEL_RTOL_LOCAL, each beside what the phase held before it
    (``held_bytes``)."""
    out, err = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise AssertionError(f"phase 20 (a): the LM dry-run exited {proc.returncode}:\n"
                             f"{err[-3000:]}")
    pred = json.loads(out.strip().splitlines()[-1])
    p8, d8 = pred["phase 8 prefill"], pred["phase 8 decode"]
    decode8 = (d8["argument_bytes"] + d8["temp_bytes"] + (LM_DECODE + 1) * d8["output_bytes"]
               + lm8["prompt_bytes"])
    cells = {
        "phase 8 granite-3-8b prefill + decode": (
            "one rank", lm8["held_bytes"] + max(_total(p8), decode8), None, lm8["peak_bytes"]),
        "phase 17 (a) smollm-360m train step": (
            "one rank", train17["held_bytes"] + _total(pred["phase 17 (a)"]), None,
            train17["peak_bytes"]),
    }
    for label, rec, runs, n in (
            ("phase 18 (a) smollm-360m 2 x 2 train step", mesh18["train"],
             [pred["phase 18 (a)"]], MESH_TRAIN[0] * MESH_TRAIN[1]),
            ("phase 18 (b) granite-3-8b 1 x 4 prefill + decode", mesh18["serve"],
             [pred["phase 18 (b) prefill"], pred["phase 18 (b) decode"]],
             MESH_SERVE[0] * MESH_SERVE[1]),
            ("phase 20 (b) smollm-360m (pod 2, data 1, model 2) train step", pod20,
             [pred["phase 20 (b)"]], math.prod(POD_TRAIN))):
        setup = rec["whole_weight_bytes"] + n * runs[0]["argument_bytes"]
        lower, upper = _local_mesh_ends(n, runs, setup)
        cells[label] = ("LocalMesh", rec["held_bytes"] + lower, rec["held_bytes"] + upper,
                        rec["peak_bytes"])
    got, missed = {}, []
    for label, (kind, lo, hi, meas) in cells.items():
        if kind == "one rank":
            rel = (lo - meas) / meas
            ok = abs(rel) <= DRYRUN_ONE_RANK_RTOL
            got[label] = {"model": kind, "predicted_peak_bytes": lo, "measured_peak_bytes": meas,
                          "rel_err": rel}
        else:
            lo_w, hi_w = lo * (1 - MODEL_RTOL_LOCAL), hi * (1 + MODEL_RTOL_LOCAL)
            ok = lo_w <= meas <= hi_w
            got[label] = {"model": kind, "lower_peak_bytes": lo, "upper_peak_bytes": hi,
                          "measured_peak_bytes": meas, "lower_rel_err": (lo - meas) / meas,
                          "upper_rel_err": (hi - meas) / meas}
        if not ok:
            missed.append(label)
        log(f"phase 20 (a) {label}: measured peak {meas} B, predicted "
            + (f"{lo} B ({got[label]['rel_err']:+.4f})" if hi is None else
               f"[{lo}, {hi}] B, lower to upper ({got[label]['lower_rel_err']:+.4f}, "
               f"{got[label]['upper_rel_err']:+.4f})"))
    if missed:
        raise AssertionError(f"phase 20 (a): measured peaks outside the LM dry-run's model: "
                             f"{ {k: got[k] for k in missed} }")
    return {"cells": got, "predictions": pred}


def pod_serve_run(model, whole, toks):
    """The meshed loss (no gradient: attention through the flash kernel, as
    serving) and the whole logits of a prefill over POD_ROWS_PREFILL tokens
    and each following decode step, from rank (0, 0, 0), on the CPU."""
    import torch
    from repro_torch.comm.spec import PartitionSpec as P
    from repro_torch.comm.spec import gather_whole

    def rank(ctx):
        p = model.shard_params(whole)
        rows = model.rank_rows({"tokens": toks})["tokens"]
        groups = {"pod": ctx.pod, "data": ctx.data, "model": ctx.model}
        spec = P(("pod", "data"), "model")
        with torch.no_grad():
            loss = float(model.loss_fn(p, {"tokens": rows}))
        lg, caches = model.prefill_fn(p, {"tokens": rows[:, :POD_ROWS_PREFILL]})
        logits = [gather_whole(lg, spec, groups)]
        for t in range(POD_ROWS_PREFILL, rows.shape[1]):
            lg, caches = model.decode_fn(p, {"tokens": rows[:, t : t + 1], "caches": caches,
                                             "pos": t})
            logits.append(gather_whole(lg, spec, groups))
        return loss, [x.cpu() for x in logits] if _rank_index(ctx) == 0 else None

    return mesh_run(model.mesh, rank)[0]


def pod_rows_card_vs_cpu(dev):
    """(c): the six attention rows reduced (head dim 64, so that the flash
    kernel takes them), float32, on POD_ROWS_MESH thread ranks: the loss,
    the prefill's and every decode step's logits on the card == the CPU's
    meshed run within POD_ROWS_TOL; the float32 kernel launched once a
    layer a rank for the loss and for the prefill (path "lm_pod_checks")."""
    import copy

    import torch
    from repro_torch.configs import get_arch
    from repro_torch.models import build_model
    from repro_torch.train import DataConfig, synthetic_batch

    b, l = POD_ROWS_SHAPE
    ranks = math.prod(POD_ROWS_MESH)
    rows, want_launches = {}, 0
    reset_launches()
    for i, row in enumerate(MESH_ROWS):
        cfg = dataclasses.replace(get_arch(row).reduced(), head_dim=64)
        w = build_model(cfg, dtype=torch.float32, device="cpu").init_fn(
            torch.Generator().manual_seed(60 + i))
        toks = synthetic_batch(DataConfig(cfg.vocab_size, b, l, seed=i), 0, "cpu")["tokens"]
        runs = []
        for d in ("cpu", dev):
            _, m = _mesh_model(cfg, POD_ROWS_MESH, d, dtype=torch.float32,
                               cache_dtype=torch.float32)
            runs.append(pod_serve_run(m, w if d == "cpu" else copy.deepcopy(w).to(d),
                                      toks.to(d)))
        (want_loss, want), (got_loss, got) = runs
        loss_err = abs(got_loss - want_loss) / abs(want_loss)
        lg_err = max(float((g - x).abs().max()) / float(x.abs().max())
                     for g, x in zip(got, want))
        rows[row] = {"loss_rel_err": loss_err, "logits_err": lg_err, "steps": len(got)}
        want_launches += 2 * cfg.num_layers * ranks
        if not (loss_err <= POD_ROWS_TOL and lg_err <= POD_ROWS_TOL):
            raise AssertionError(f"phase 20 (c) {row}: card vs CPU loss {loss_err}, logits "
                                 f"{lg_err}")
    launches = read_launches()
    if launches["flash_attention_fp32"] != want_launches or launches["flash_attention"]:
        raise AssertionError(f"phase 20 (c): launches {launches}, want {want_launches} float32")
    log(f"phase 20 (c) six rows reduced (head dim 64), float32, on "
        f"{' x '.join(map(str, POD_ROWS_MESH))} (pod, data, model): card == CPU (loss / "
        f"logits, relative): " + ", ".join(f"{k} {v['loss_rel_err']:.2g}/{v['logits_err']:.2g}"
                                          for k, v in rows.items())
        + f"; float32 flash launches {launches['flash_attention_fp32']}")
    return launches, rows


def phase_pod(dev, dryrun_proc, lm8, train17, mesh18):
    """Phase 20: (a) the LM dry-run against the measured peaks, (b)
    smollm-360m whole on the pod mesh with the production sharding, (c)
    the six attention rows reduced on (2, 2, 2), card == CPU."""
    import torch
    from repro_torch.configs import get_arch

    torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    part_s = {}
    t0 = time.perf_counter()
    cfg = get_arch(TRAIN_ARCH)
    # what launch/train.py --production-mesh --multi-pod builds
    prod = dict(fsdp=cfg.params_count() >= 2e9, seq_axis="model")
    train = mesh_train(dev, train17["losses"], label="phase 20 (b)", warm=POD_WARM,
                       timed=POD_TIMED, against="phase 17 (a)", f32_check=False,
                       shape=POD_TRAIN, **prod)
    train["sharding"] = dict(prod, batch_axes=["pod", "data"])
    part_s["train"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    checks, rows = pod_rows_card_vs_cpu(dev)
    part_s["card_vs_cpu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dry = pod_dryrun(dryrun_proc, lm8, train17, mesh18, train)
    part_s["dryrun_wait"] = time.perf_counter() - t0
    dt = time.perf_counter() - t_start
    log(f"phase 20 passed in {dt:.1f}s ({', '.join(f'{k} {v:.1f}s' for k, v in part_s.items())})")
    return checks, {"dryrun": dry, "train_pod": train, "card_vs_cpu": rows,
                    "part_seconds": part_s, "seconds": dt}


# ---------------------------------------------------------------------------
# phase 21: the port's examples on the card
# ---------------------------------------------------------------------------

#: (b): torch_count_distributed at a reduced graph (its defaults: 2^14 / 150,000, 8 shards)
EXAMPLE_DIST_ARGS = ["--vertices", str(1 << 12), "--edges", "40000", "--shards", "4",
                     "--iters", "8", "--fuse"]
EXAMPLE_DIST_RTOL = 1e-5  # (b): each mode's samples vs the single device's, same colorings
#: (c): torch_train_lm on the reduced smollm-360m (its defaults: B = 8 x 128)
EXAMPLE_TRAIN_ARGS = ["--arch", "smollm-360m", "--log-every", "1"]
EXAMPLE_TRAIN_STEPS = (2, 4)  # (c): the checkpointed run's steps, then the resumed run's
EXAMPLE_RESUME_RTOL = 1e-6  # (c): resumed losses and weights vs the uninterrupted run's
EXAMPLE_KERNELS = ("spmm_edgetile", "color_combine", "fused_count")


def _example(name: str, argv):
    """``examples/<name>.py``'s ``main(argv)``, its output logged indented."""
    import importlib.util

    path = ROOT / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = mod.main(argv)
    log("".join(f"  {line}\n" for line in buf.getvalue().splitlines()).rstrip())
    return out


def phase_examples(dev):
    """Phase 21: the three examples through their ``main``.  (a)
    torch_quickstart at its own sizes on the card, then on the CPU: the
    samples of the estimate and of the family bitwise equal (counts are
    integer-valued float32); a fixed coloring's count on the card == the
    brute-force oracle's.  (b) torch_count_distributed at a reduced graph,
    fused, one timed call a mode on LocalMesh thread ranks: every mode's
    samples within 1e-5 of the single-device counts of the same colorings.
    (a) and (b) launch each counting kernel at least once.  (c)
    torch_train_lm on the reduced smollm-360m: 2 steps with a checkpoint,
    a resumed run to step 4, and an uninterrupted run to step 4: losses and
    weights within 1e-6 relative."""
    import numpy as np
    import torch
    from repro_torch.api import Counter
    from repro_torch.core.brute_force import count_colorful_maps

    torch.cuda.synchronize(dev)
    t_start = time.perf_counter()
    part_s = {}
    t0 = time.perf_counter()
    reset_launches()
    card = _example("torch_quickstart", ["--device", "cuda"])
    quick_launches = read_launches()
    cpu = _example("torch_quickstart", ["--device", "cpu"])
    for what, a, b in (("estimate", card["estimate"].samples, cpu["estimate"].samples),
                       ("family", card["many"].samples, cpu["many"].samples)):
        if a.shape != b.shape or not np.array_equal(a, b):
            raise AssertionError(f"phase 21 (a): the quickstart's {what} samples on the card "
                                 f"{a} vs the CPU's {b}")
    g, tree = card["graph"], card["tree"]
    coloring = np.random.default_rng(0).integers(0, tree.n, g.n).astype(np.int32)
    maps = Counter.from_graph(g, tree, device=dev).count_coloring(coloring)
    oracle = count_colorful_maps(g, tree, coloring)
    if maps != oracle:
        raise AssertionError(f"phase 21 (a): a fixed coloring's count {maps} vs brute force "
                             f"{oracle}")
    log(f"phase 21 (a): quickstart samples card == CPU bitwise ({card['estimate'].niter} + "
        f"{card['many'].niter} colorings); fixed coloring {maps:.0f} == brute force; exact "
        f"{card['exact']:.0f}, estimate {card['estimate'].estimate:.0f}; launches "
        f"{quick_launches}")
    part_s["quickstart"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    reset_launches()
    dist = _example("torch_count_distributed", ["--device", "cuda"] + EXAMPLE_DIST_ARGS)
    dist_launches = read_launches()
    worst = max(m["rel"] for m in dist["modes"].values())
    if not worst <= EXAMPLE_DIST_RTOL:
        raise AssertionError(f"phase 21 (b): a mode {worst} from the single device's counts")
    launched = {k: quick_launches[k] + dist_launches[k] for k in EXAMPLE_KERNELS}
    if not all(launched.values()):
        raise AssertionError(f"phase 21: a counting kernel was never launched: {launched}")
    mode_ms = {label: round(m["ms"], 1) for label, m in dist["modes"].items()}
    log(f"phase 21 (b): every mode within {worst:.2g} of the single device's counts; ms a timed "
        f"call {mode_ms}; launches {dist_launches}")
    part_s["distributed"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    part, steps = EXAMPLE_TRAIN_STEPS
    with tempfile.TemporaryDirectory(prefix=".smoke_tmp", dir=ROOT) as tmp:
        common = EXAMPLE_TRAIN_ARGS + ["--device", "cuda", "--checkpoint-every", str(part)]
        first = _example("torch_train_lm", common + ["--steps", str(part),
                                                     "--ckpt-dir", f"{tmp}/resumed"])
        resumed = _example("torch_train_lm", common + ["--steps", str(steps),
                                                       "--ckpt-dir", f"{tmp}/resumed"])
        whole = _example("torch_train_lm", common + ["--steps", str(steps),
                                                     "--ckpt-dir", f"{tmp}/whole"])
    if resumed["start"] != part or sorted(resumed["losses"]) != list(range(part + 1, steps + 1)):
        raise AssertionError(f"phase 21 (c): the resumed run started at {resumed['start']}")
    loss_err = max(abs(resumed["losses"][i] - whole["losses"][i]) / abs(whole["losses"][i])
                   for i in resumed["losses"])
    errs = _rel_errs(dict(resumed["params"].named_parameters()),
                     dict(whole["params"].named_parameters()))
    if not (loss_err <= EXAMPLE_RESUME_RTOL and max(errs.values()) <= EXAMPLE_RESUME_RTOL):
        raise AssertionError(f"phase 21 (c): resumed losses {resumed['losses']} vs "
                             f"{whole['losses']}, weights {max(errs.values())}")
    if any(first["losses"][i] != whole["losses"][i] for i in first["losses"]):
        log(f"phase 21 (c): the first {part} steps differ from the uninterrupted run's "
            f"(atomics): {first['losses']} vs {whole['losses']}")
    log(f"phase 21 (c): resumed at step {part} to {steps}: losses within {loss_err:.3g}, "
        f"weights within {max(errs.values()):.3g} of the uninterrupted run's")
    part_s["train"] = time.perf_counter() - t0
    dt = time.perf_counter() - t_start
    log(f"phase 21 passed in {dt:.1f}s ({', '.join(f'{k} {v:.1f}s' for k, v in part_s.items())})")


# ---------------------------------------------------------------------------


#: the redesigned count-table kernels' designs, and where the times of the
#: designs they replace are recorded (this run does not measure them, so
#: gives none)
DESIGNS = {
    "spmm_edgetile": dict(
        design="warp per (row, 128-float chunk of the B*W row), float4 gathers, 8 in flight, "
               "chunk-major grid",
        earlier_design="warp per (row, coloring), 32 columns a pass, scalar gathers, 4 in flight",
        earlier_ms="PERF.md kernel table row 1"),
    "spmm_block": dict(
        design="producer warps stage each patch's slot lists and used rows with cp.async.bulk "
               "into a ring of mbarrier stages; 16 consumer warps add in CSR order",
        earlier_design="one serial chain a patch: bitmask load, union by one warp, synchronous "
                       "staging, four barriers",
        earlier_ms="PERF.md kernel table row 4"),
    "color_combine": dict(
        design="CTA per tile of up to 128 rows staged column-major in shared memory (odd "
               "pitch); a warp item is 32 rows x 1-4 output columns (a chain each a lane), "
               "split entries 16-byte broadcasts prefetched with cp.async; outputs out "
               "through shared memory in coalesced rows",
        earlier_design="thread per (row, s), operands at scattered columns through L1",
        earlier_ms="PERF.md kernel table row 2"),
    "fused_count": dict(
        design="CTA per tile of whole vertices, four CTAs an SM where they fit: phase 1 "
               "csr_chunk_gather units (vertex, 128 floats) taken in turn from a counter, "
               "into M in shared memory; phase 2 the combine's tile",
        earlier_design="1024-thread CTA per 64 rows and one coloring, csr_row_sum walk",
        earlier_ms="PERF.md kernel table row 3"),
}


def kernels_line(rows, dense_rows, launches, per, draw_ms, dense, flash, lm, order, wide, dags,
                 sparse, dist, compact, dryrun, train, mesh, mesh_rows, pod, card):
    flash, flash32, flash256, flash256_32, sass, d256_launches = flash
    lm, lm_rows = lm
    mesh_flash, mesh = mesh
    rows19_flash, rows19_d256, rows19 = mesh_rows

    def rank_launch(r):
        return {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "err")} | {
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
    meta = {
        "spmm_edgetile": ("src/repro_torch/kernels/csrc/spmm_edgetile.cu",
                          "src/repro/kernels/spmm_edgetile.py:137"),
        "spmm_block": ("src/repro_torch/kernels/csrc/spmm_block.cu",
                       "src/repro/kernels/spmm_edgetile.py:73"),
        "color_combine": ("src/repro_torch/kernels/csrc/color_combine.cu",
                          "src/repro/kernels/color_combine.py:56"),
        "fused_count": ("src/repro_torch/kernels/csrc/fused_count.cu",
                        "src/repro/kernels/fused_count.py:105"),
    }
    rows = dict(rows, spmm_block=dense_rows)
    out = []
    for name in meta:
        shapes = rows[name]
        # one DP pass of u12-2 at the cell's batch: each node shape times its count
        tot = lambda key: sum(r[key] * r["mult"] for r in shapes)  # noqa: E731
        b_ms = sum(r["bound"][0] * r["mult"] for r in shapes)
        b_by = max(shapes, key=lambda r: r["bound"][0] * r["mult"])["bound"][1]
        src, rep = meta[name]
        lib = tot("library_ms") if shapes[0]["library_ms"] is not None else None
        # every exact check of the kernel, on the main cell and the DAG paths
        sparse_rows, sparse_path = sparse
        errs = [r["err"] for r in shapes] + [r["err"] for d_rows, _ in dags.values()
                                              for r in d_rows.get(name, [])]
        errs += [r["err"] for r in sparse_rows.get(name, [])]
        errs += [r["err"] for r in dist[0].get(name, [])]
        errs += [r["err"] for r in compact[0].get(name, [])]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": rep,
            "launches": sum(p[name] for p in launches.values()),
            "launches_by_path": {path: p[name] for path, p in launches.items()},
            "max_abs_err": max(errs),
            "ms": tot("ms"), "plain_ms": tot("plain_ms"),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib, "check": "exact (==)",
            "cell": "dense" if name == "spmm_block" else "main",
            "per_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms")}
                          | {"bound_ms": r["bound"][0], "gather_bound_ms": r["gather_ms"]}
                          | {k: r[k] for k in ("edgetile_ms", "staging_ms", "hub_cut_ms",
                                               "staged_floor_ms") if k in r}
                          | ({f"block_ref_ms_{DENSE_PLAIN_BLOCKS}_row_blocks": r["block_ref_ms"],
                              f"kernel_ms_{DENSE_PLAIN_BLOCKS}_row_blocks": r["sample_ms"]}
                             if "block_ref_ms" in r else {})
                          for r in shapes],
        }
        if name == "spmm_block":
            entry |= {"edgetile_ms": tot("edgetile_ms"), "staging_bound_ms": tot("staging_ms"),
                      "plain": "spmm_segment_ref (index_add_) on the whole graph",
                      f"block_ref_ms_{DENSE_PLAIN_BLOCKS}_row_blocks": tot("block_ref_ms"),
                      f"kernel_ms_{DENSE_PLAIN_BLOCKS}_row_blocks": tot("sample_ms"),
                      "library": "torch.sparse.mm, CSR"}
        if name in DESIGNS:
            entry |= DESIGNS[name] | {"sass": sass[name]}
        if name in order:
            entry["order_check"] = order[name]
        if name in ("color_combine", "fused_count"):
            key = "fused" if name == "fused_count" else "combine"
            entry["wide_nodes"] = {n: {k: v for k, v in r.items() if k.startswith(key)}
                                   for n, r in wide.items()}
        if name == "spmm_edgetile":
            entry["hub_cut_ms"] = tot("hub_cut_ms")
        for path, (d_rows, _) in dags.items():
            if d_rows.get(name):
                entry[f"{path}_pass"] = pass_totals({name: d_rows[name]})[name] | {
                    "per_shape": [{k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms")}
                                  | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                                  for r in d_rows[name]]}
        if sparse_rows.get(name):
            # phase 11: the kernel on a compact source or gathered rows, at
            # one engaged node of each compacted row (ms per launch)
            entry["sparse_checks"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "err")}
                | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                for r in sparse_rows[name]]
        if dist[0].get(name):
            # phase 12: the kernel on the distributed path's rectangular
            # alltoall CSR and a bucket CSR (the combine on a shard's rows),
            # ms per launch at u12-2's DIST_CHECK_NODE
            entry["distributed_checks"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "err")}
                | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                for r in dist[0][name]]
        if compact[0].get(name):
            # phase 13: the same on a compacted plan's exchanged node of
            # u10-2 at 2^22 (each sparse row), ms per launch
            entry["distributed_compact_checks"] = [
                {k: r[k] for k in ("shape", "ms", "plain_ms", "library_ms", "err")}
                | {"bound_ms": r["bound"][0], "bound_by": r["bound"][1]}
                for r in compact[0][name]]
        if name in ("color_combine", "fused_count"):
            # bytes, shared-memory reads of the FMAs and, fused, the gathers
            entry["staged_floor_ms"] = tot("staged_floor_ms")
        out.append(entry)
    for name, row, src, extra in (
            ("flash_attention", flash, "flash_attention_wgmma.cu", {
                "design": "wgmma+tma, split P (three bf16 terms)",
                "earlier_design": "float32 FMAs on the CUDA cores (flash_attention_fp32; "
                                  "PR 13's bf16 time is in PERF.md row 5)",
                "sass": sass["flash_attention_wgmma"],
                "library_bf16_excess": flash["library_bf16_excess"],
                "library_share_beyond_gate": flash["library_share_beyond_gate"],
                "check": f"within one bf16 step of the plain version + {FLASH_BF16_ATOL}",
                "cell": "lm",
                # phase 18 (b): a rank's launch of the meshed prefill (1 x 4)
                "lm_mesh_rank_launch": rank_launch(mesh_flash),
                # phase 19: a rank's launch at each new shape of the other
                # rows' meshed prefills (the D = 256 one under its own entry)
                "lm_mesh_rows_rank_launches": [rank_launch(r) for r in rows19_flash
                                               if r["d"] != 256]}),
            ("flash_attention_fp32", flash32, "flash_attention.cu", {
                "design": "float32 FMAs on the CUDA cores: 128-row query tiles (64 at D = 256), "
                          "a cp.async ring of 64-key K and V tiles, 8 x 4 logits a lane "
                          "(4 x 4 at D = 256), P through each warp's own block",
                "sass": sass["flash_attention"],
                "check": f"within {FLASH_F32_TOL} of the plain version",
                "cell": "lm (its float32 checks)"})):
        out.append({
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": "src/repro/kernels/flash_attention.py:111",
            "launches": sum(p[name] for p in launches.values()),
            "launches_by_path": {path: p[name] for path, p in launches.items()},
            "max_abs_err": row["err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "time_unit": f"ms per launch at {row['shape']}",
            "library": "torch.nn.functional.scaled_dot_product_attention"} | extra)
    for name, row, src, base in (
            ("flash_attention_d256", flash256, "flash_attention_wgmma.cu", "flash_attention"),
            ("flash_attention_fp32_d256", flash256_32, "flash_attention.cu",
             "flash_attention_fp32")):
        # the same sources at D = 256 (64-key KV tiles in the bf16 kernel):
        # recurrentgemma's local layers, phase 16; their launches are part of
        # the D-agnostic entries' counts above as well
        path = "lm_rows" if base == "flash_attention" else "lm_rows_float32_checks"
        by_path = {path: d256_launches[path]}
        extra = {}
        if base == "flash_attention":  # phase 19 (a): recurrentgemma's anchored ranks
            by_path["lm_mesh_rows"] = rows19_d256
            extra = {"lm_mesh_rows_rank_launch": [rank_launch(r) for r in rows19_flash
                                                  if r["d"] == 256]}
        out.append(extra | {
            "name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": "src/repro/kernels/flash_attention.py:111",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": row["err"], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound"][0], "bound_by": row["bound"][1],
            "library_ms": row["library_ms"], "time_unit": f"ms per launch at {row['shape']}",
            "library": "torch.nn.functional.scaled_dot_product_attention (boolean window mask)",
            "check": (f"within one bf16 step of the plain version + {FLASH_BF16_ATOL}"
                      if base == "flash_attention" else f"within {FLASH_F32_TOL} of the plain "
                      "version"), "cell": "lm_rows (recurrentgemma-2b local layers)"})
    main_path = {("fused" if fuse else "unfused"): {"ms_per_coloring": ms, "peak_bytes": peak}
                 for fuse, (ms, peak) in per.items()}
    main_path["draw_colorings_ms"], main_path["unfused_predrawn_ms_per_coloring"] = draw_ms
    return {"kernels": out, "card": card, "batch": {"main": MAIN_BATCH, "dense": DENSE_BATCH,
                                                 "family": FAMILY_BATCH, "tw2": TW2_BATCH,
                                                 "distributed": DIST_BATCH,
                                                 "serve": dags["serve"][1]["batch"]},
            "time_unit": "ms per u12-2 DP pass over all node shapes", "main_path": main_path,
            "dense_path": dense,
            "family_path": dags["family"][1], "tw2_path": dags["tw2"][1],
            "sparse_path": sparse[1], "distributed_path": dist[1],
            "distributed_compact_path": compact[1], "serve_path": dags["serve"][1],
            "dryrun": dryrun,
            "lm_path": {"arch": LM_ARCH, "batch": LM_BATCH, "prompt_len": LM_LEN,
                        "decode_steps": LM_DECODE}
            | {k: v for k, v in lm.items()
               if k not in ("launches", "float32_check_launches", "mesh_refs")},
            "lm_rows_path": lm_rows, "train_path": train, "mesh_path": mesh,
            "mesh_rows_path": rows19, "pod_path": pod}


def run_phases(dev):
    """Every phase in order on ``dev``; returns what the kernels line reports.
    Phase 20 (a)'s dry-run process starts first, on the host beside the
    card's phases, and is stopped if a phase fails before it is read."""
    lm_dryrun = start_lm_dryrun()
    try:
        return _run_phases(dev, lm_dryrun)
    finally:
        if lm_dryrun.poll() is None:
            lm_dryrun.kill()
            lm_dryrun.communicate()


def _run_phases(dev, lm_dryrun):
    import torch
    from repro_torch.core.count_engine import build_counting_plan
    from repro_torch.core.templates import template

    sass = phase_build()
    g = rmat_graph(2 ** 20, 10_000_000)
    t0 = time.perf_counter()
    plan = build_counting_plan(g, template("u12-2"), device=dev)
    log(f"u12-2 plan on {dev}: n_pad={plan.n_pad} in {time.perf_counter() - t0:.1f}s")
    rows, order_main = phase_kernels(plan, MAIN_BATCH)
    wide = phase_kernels_wide(dev, MAIN_BATCH)
    phase_exact(dev)
    main_launches, per, draw_ms = phase_main(plan, MAIN_BATCH, MAIN_CALLS)
    del plan
    torch.cuda.empty_cache()
    family_launches, family_rows, family = phase_family(g, dev)
    torch.cuda.empty_cache()
    dist_launches, dist_rows, dist, (saturation, narrow_nccl), model_inputs = \
        phase_distributed(g, dev)
    torch.cuda.empty_cache()
    serve_launches, serve_rows, serve = phase_serve(g, dev)
    del g
    torch.cuda.empty_cache()
    dense_graph = rmat_graph(2 ** 16, 16_000_000)
    t0 = time.perf_counter()
    dplan = build_counting_plan(dense_graph, template("u12-2"), spmm_kind="auto", device=dev)
    log(f"u12-2 dense plan on {dev}: kind={dplan.spmm_plan.kind} n_pad={dplan.n_pad} "
        f"{dplan.spmm_plan.num_patches} patches in {time.perf_counter() - t0:.1f}s")
    if dplan.spmm_plan.kind != "blocks":
        raise AssertionError(f"spmm_kind='auto' planned {dplan.spmm_plan.kind} on the dense cell")
    dense_rows, order_dense = phase_kernels_dense(dplan, DENSE_BATCH)
    del dplan
    torch.cuda.empty_cache()
    dense = phase_dense(dense_graph, dev)
    del dense_graph
    phase_launch()
    flash, flash32, flash256, flash256_32 = phase_flash(dev)
    lm = phase_lm(dev, flash["ms"])
    torch.cuda.empty_cache()
    rows_served, rows_checks, d256_launches, lm_rows = phase_lm_rows(dev)
    train = phase_train(dev)
    mesh_launches, mesh_checks, mesh_flash, mesh = phase_mesh(dev, train["smollm"]["losses"],
                                                              lm.pop("mesh_refs"))
    rows19_launches, rows19_checks, rows19_d256, rows19_flash, rows19 = phase_mesh_rows(dev)
    pod_checks, pod = phase_pod(dev, lm_dryrun, lm, train["smollm"], mesh)
    tw2_launches, tw2_rows, tw2 = phase_tw2(dev)
    sparse_graphs = {}
    sparse_launches, sparse_rows, sparse = phase_sparse(dev, sparse_graphs)
    torch.cuda.empty_cache()
    compact_launches, compact_rows, compact = phase_compact(dev, saturation, narrow_nccl,
                                                            sparse_graphs)
    phase_examples(dev)
    launches = {"main": main_launches,
                "dense": {k: dense["auto"]["launches"][k] + dense["edges"]["launches"][k]
                          for k in main_launches},
                "lm": lm["launches"], "lm_float32_checks": lm["float32_check_launches"],
                "lm_rows": rows_served, "lm_rows_float32_checks": rows_checks,
                "lm_mesh": mesh_launches, "lm_mesh_float32_checks": mesh_checks,
                "lm_mesh_rows": rows19_launches, "lm_mesh_rows_checks": rows19_checks,
                "lm_pod_checks": pod_checks,
                "family": family_launches, "tw2": tw2_launches, "sparse": sparse_launches,
                "distributed": dist_launches, "distributed_compact": compact_launches,
                "serve": serve_launches}
    for name in main_launches:
        if not sum(p[name] for p in launches.values()):
            raise AssertionError(f"{name} was never launched on a path: {launches}")
    order = {"spmm_edgetile": order_main, "spmm_block": order_dense, "fused_count": order_main}
    dags = {"family": (family_rows, family), "tw2": (tw2_rows, tw2), "serve": (serve_rows, serve)}
    flash_rows = (flash, flash32, flash256, flash256_32)
    dryrun = phase_dryrun(model_inputs, dist["full"], timed_rows(
        rows, dense_rows, dags, sparse_rows, dist_rows, compact_rows, flash_rows)
        + [("flash_attention", r) for r in rows19_flash])
    return (rows, dense_rows, launches, per, draw_ms, dense, (*flash_rows, sass, d256_launches),
            (lm, lm_rows), order, wide, dags, (sparse_rows, sparse), (dist_rows, dist),
            (compact_rows, compact), dryrun, train, (mesh_flash, mesh),
            (rows19_flash, rows19_d256, rows19), pod)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    results = run_phases(torch.device("cuda", 0))
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(card)
    print(json.dumps(kernels_line(*results, card)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
