#!/usr/bin/env python3
"""The float32 flash-attention kernel (``csrc/flash_attention.cu``) alone on
one CUDA card: build it, print ``ptxas``'s register and shared-memory report
and the SASS instructions its design rests on, hold it against its plain
version within 1e-5 at the tile's edges, and time it at granite-3-8b's and
recurrentgemma-2b's prefill launches beside the plain version, PyTorch's
``scaled_dot_product_attention`` (a yardstick the port never calls) and the
bound of ``repro_torch.kernels.work.flash_attention``.

    python3 tools/torch_flash_fp32.py [--reps 5] [--no-time] [--baseline OTHER.cu ...]

``--baseline`` builds other versions of the source (an earlier commit's,
unpacked with ``git archive``) beside this one and times each against it
on the same inputs in turns (other, this, this, other).  Prints one line per check and
timing and, last, one JSON object with the card, the SASS counts and the
timed rows.  Fails without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5  # float32 kernel vs float32 plain version: summation order
#: (name, (B, Hq, Hkv, L, D), causal, window): the two timed launches
TIMED = (("granite-3-8b prefill", (4, 32, 8, 4096, 128), True, 0),
         ("recurrentgemma-2b local layers", (2, 10, 1, 4096, 256), True, 2048))
#: checked shapes at the new tiles' edges: L one past a tile, GQA groups 1
#: and 8, D = 64 with a window, ragged and bidirectional at every D
CHECKS = ((1, 8, 8, 129, 128, True, 0), (1, 8, 8, 65, 256, True, 0),
          (2, 32, 4, 300, 128, True, 0), (1, 8, 1, 1000, 64, True, 300),
          (2, 8, 2, 1000, 64, False, 300), (1, 10, 1, 127, 256, True, 0),
          (2, 10, 1, 1000, 256, False, 0), (1, 4, 2, 1, 128, True, 0),
          (1, 32, 8, 1024, 128, True, 0), (1, 10, 1, 1000, 256, True, 300))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5, help="timed launches after one warm one")
    ap.add_argument("--no-time", action="store_true", help="build and check only")
    ap.add_argument("--baseline", type=Path, nargs="*", default=[],
                    help="other flash_attention.cu sources to time beside")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_flash_fp32: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref, work
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.roofline.analysis import bound_s

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    _build.build(["flash_attention"], verbose=True)
    sass = _build.sass("flash_attention") or ""
    ops = {op: sum(op in line for line in sass.splitlines())
           for op in ("LDGSTS", "FFMA", "HMMA", "HGMMA")}
    print(f"SASS: {ops}", flush=True)
    bases = {str(path): _baseline(path, i, _build, fa) for i, path in enumerate(args.baseline)}
    gen = torch.Generator(device="cuda").manual_seed(77)

    def qkv(b, hq, hkv, l, d):
        return [torch.randn(s, generator=gen, device="cuda")
                for s in ((b, hq, l, d), (b, hkv, l, d), (b, hkv, l, d))]

    def check(q, k, v, causal, window):
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
        err = (got - want).abs().max().item()
        if not err <= TOL or not torch.isfinite(got).all():
            raise AssertionError(f"{tuple(q.shape)} causal={causal} window={window}: "
                                 f"max_abs_err {err} > {TOL}")
        return err

    for b, hq, hkv, l, d, causal, window in CHECKS:
        err = check(*qkv(b, hq, hkv, l, d), causal, window)
        print(f"B={b} Hq={hq} Hkv={hkv} L={l} D={d} causal={causal} window={window}: "
              f"max_abs_err {err:.3g}", flush=True)
    rows = []
    for name, (b, hq, hkv, l, d), causal, window in TIMED:
        q, k, v = qkv(b, hq, hkv, l, d)
        err = check(q, k, v, causal, window)
        bound, by = bound_s(work.flash_attention(b, hq, hkv, l, d, 4, causal, window))
        row = {"name": name, "shape": [b, hq, hkv, l, d], "causal": causal, "window": window,
               "max_abs_err": err, "bound_ms": bound * 1e3, "bound_by": by}
        if not args.no_time:
            pos = torch.arange(l, device="cuda")
            diff = pos[:, None] - pos[None, :]
            mask = (diff >= 0) & ((diff < window) if window else True)
            new = lambda: fa.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
            for path, base in bases.items():
                err_b = (base(q, k, v, causal, window) - ref.flash_attention_ref(
                    q, k, v, causal=causal, window=window)).abs().max().item()
                old = lambda: base(q, k, v, causal, window)  # noqa: E731
                turns = [_ms(fn, args.reps) for fn in (old, new, new, old)]
                row.setdefault("baselines", {})[path] = {
                    "ms": (turns[0] + turns[3]) / 2, "turns_ms": turns, "max_abs_err": err_b}
            row.update(
                ms=_ms(new, args.reps),
                plain_ms=_ms(lambda: ref.flash_attention_ref(q, k, v, causal=causal,
                                                             window=window), 1),
                library_ms=_ms(_sdpa(F, q, k, v, mask), args.reps))
            row["share_of_bound"] = row["bound_ms"] / row["ms"]
        print(f"{name}: {row}", flush=True)
        rows.append(row)
        del q, k, v
    print(json.dumps({"card": card, "sass": ops, "rows": rows}))
    return 0


def _baseline(path: Path, index: int, _build, fa):
    """``flash_attention_launch`` of another source, built beside this one's
    library; returns ``run(q, k, v, causal, window) -> out``."""
    import ctypes as ct

    import torch

    out = _build._BUILD_DIR / f"libflash_attention_baseline{index}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    built = subprocess.run([_build._nvcc(), "-gencode", _build._ARCH, "-std=c++17", "-O3",
                            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out),
                            str(path)], check=True, capture_output=True, text=True)
    print(f"[nvcc {path}]", *[line for line in (built.stdout + built.stderr).splitlines()
                              if "registers" in line or "spill" in line], sep="\n", flush=True)
    fn = ct.CDLL(str(out)).flash_attention_launch
    fn.argtypes, fn.restype = fa._FP32_ARGTYPES, ct.c_int

    def run(q, k, v, causal, window):
        o = torch.empty_like(q)
        b, hq, l, d = q.shape
        _build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, hq,
                        k.shape[1], l, d, int(causal), int(window),
                        torch.cuda.current_stream().cuda_stream), "baseline launch")
        return o

    return run


def _sdpa(F, q, k, v, mask):
    """SDPA on the same inputs, GQA by the library where it takes it."""
    if "enable_gqa" in (F.scaled_dot_product_attention.__doc__ or ""):
        return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)
    g = q.shape[1] // k.shape[1]
    kr, vr = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    return lambda: F.scaled_dot_product_attention(q, kr, vr, attn_mask=mask)


def _ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm one."""
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


if __name__ == "__main__":
    sys.exit(main())
