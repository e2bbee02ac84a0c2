"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with ``ctypes``.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a`` (Hopper).  Libraries go into ``kernels/build/`` (listed in
``.gitignore``) under a name that carries a digest of the sources, so an
edited kernel is never served from a stale library.  :func:`build`
compiles every missing library in parallel, one ``nvcc`` process each;
:func:`kernel_fn` builds on first use; :func:`sass` disassembles a built
library with ``cuobjdump``.  Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence

__all__ = ["KERNELS", "build", "kernel_fn", "check", "count_launch", "sass"]

#: one shared library per source file
KERNELS = ("spmm_edgetile", "spmm_block", "color_combine", "fused_count", "flash_attention",
           "flash_attention_wgmma")

_CSRC = Path(__file__).resolve().parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parent / "build"
_ARCH = "arch=compute_90a,code=sm_90a"
_libs: Dict[str, ctypes.CDLL] = {}
#: guards first builds and the launch counts: the distributed engine's
#: LocalMesh ranks are threads that launch the same kernels
_lock = threading.RLock()


def _tool(name: str, env: str = "") -> Optional[str]:
    """A CUDA toolkit program: ``$env``, on PATH, or under CUDA_HOME."""
    for cand in (
        os.environ.get(env) if env else None,
        shutil.which(name),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", name),
    ):
        if cand and os.path.isfile(cand):
            return cand
    return None


def _nvcc() -> str:
    nvcc = _tool("nvcc", "NVCC")
    if nvcc is None:
        raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc on PATH")
    return nvcc


def _lib_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in [_CSRC / f"{name}.cu", *sorted(_CSRC.glob("*.cuh"))]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return _BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Iterable[str] = KERNELS, *, verbose: bool = False) -> Dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all at once.

    Returns the wall-clock seconds of the whole build per library (0.0 for
    one found built).  ``verbose`` prints ``nvcc``'s output, which carries
    ``ptxas``'s register and shared-memory report for each kernel.
    """
    names = list(names)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [
            nvcc, "-gencode", _ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
            "-Xptxas", "-v", "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / f"{name}.cu"),
        ]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), tmp, out)
    times = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if verbose or proc.returncode != 0:
            print(f"[nvcc {name}] rc={proc.returncode}\n{log}", flush=True)
        if proc.returncode != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)  # atomic: a concurrent reader sees the whole file or none
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)} (log above)")
    return times


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                path = _lib_path(name)
                if not path.exists():
                    build([name])
                lib = _libs[name] = ctypes.CDLL(str(path))
    return lib


def kernel_fn(name: str, symbol: str, argtypes: Sequence) -> ctypes._CFuncPtr:
    """The C entry ``symbol`` of library ``name``, with its signature set.

    Every pointer and the stream are ``c_void_p`` (a bare Python int would
    be passed as a 32-bit C int and cut); entries return an ``int``.
    """
    fn = getattr(_lib(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def count_launch(fn, *attrs: str) -> None:
    """Add one to each launch count ``attrs`` of wrapper ``fn`` (default
    ``launches``), under a lock: a bare ``+= 1`` from two threads can lose
    one."""
    with _lock:
        for attr in attrs or ("launches",):
            setattr(fn, attr, getattr(fn, attr) + 1)


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (``cudaGetLastError()``)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def sass(name: str) -> Optional[str]:
    """``cuobjdump -sass`` of library ``name`` (built first if it is not),
    or None where the toolkit has no ``cuobjdump``."""
    tool = _tool("cuobjdump")
    if tool is None:
        return None
    path = _lib_path(name)
    if not path.exists():
        build([name])
    return subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
