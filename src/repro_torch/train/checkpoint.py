"""Atomic, checksummed checkpoints of dicts of numpy arrays.

The port's counterpart of the parts of ``repro/train/checkpoint.py`` that
the counting API's checkpoint and resume use (DESIGN.md §7, §16):

* **atomic** — writes go to ``step_XXXX.tmp/`` and are renamed only after a
  manifest with content checksums is fsynced; a crash mid-save never
  corrupts the latest checkpoint (the ``checkpoint.write_crash`` fault site
  kills the writer between the two);
* **synchronous** — estimator state is a few kilobytes, so ``save``
  returns once the checkpoint is on disk: "killed after the save at call
  N" is then a well-defined resume point;
* **bounded** — keeps the last ``keep`` checkpoints, never the one a run
  was restored from.

Storage is one ``.npz`` per named dict.  The reference's pytree
``restore`` onto a mesh waits for the distributed slice.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from ..testing import faults

__all__ = ["CheckpointManager"]


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        #: the step load_latest() last read: keep-pruning never
        #: deletes the checkpoint a live run was restored from
        self._protected: Optional[int] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, trees: Mapping[str, Mapping[str, np.ndarray]]):
        """``trees``: name -> {array name: array} (e.g. ``{"estimator":
        state.to_arrays()}``)."""
        self._gc_tmp()  # crash residue from a previously killed writer
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "trees": {}}
        for name, flat in trees.items():
            path = os.path.join(tmp, f"{name}.npz")
            np.savez(path, **{k: np.asarray(v) for k, v in flat.items()})
            with open(path, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            manifest["trees"][name] = {"file": f"{name}.npz", "sha256": digest}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        spec = faults.fire("checkpoint.write_crash")
        if spec is not None:
            # simulate a kill between the tmp write and the atomic rename:
            # the .tmp dir stays behind, the previous checkpoint stays latest
            raise faults.InjectedCrash(
                f"injected writer kill before renaming {tmp}"
            )
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            if s == self._protected:
                continue  # never delete the checkpoint a run restored from
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def _gc_tmp(self):
        """Remove ``step_*.tmp`` residue left by a killed writer: its
        rename never happened, so it can never become a valid checkpoint."""
        for d in os.listdir(self.dir):
            if d.startswith("step_") and d.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------------------------------------------------- restore
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, d, "manifest.json")):
                    out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _try_load(self, step: int) -> Optional[Dict[str, Dict[str, np.ndarray]]]:
        """Load one checkpoint as raw flat arrays; ``None`` if unreadable.

        Verifies every tree file against the manifest's sha256 — a
        truncated npz, a flipped bit, or a missing file all read as "this
        checkpoint does not exist", never as wrong data.
        """
        base = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(base, "manifest.json")) as f:
                manifest = json.load(f)
            out: Dict[str, Dict[str, np.ndarray]] = {}
            for name, meta in manifest["trees"].items():
                path = os.path.join(base, meta["file"])
                with open(path, "rb") as f:
                    digest = hashlib.sha256(f.read()).hexdigest()
                if digest != meta["sha256"]:
                    raise IOError(f"checksum mismatch for {name}")
                with np.load(path, allow_pickle=False) as z:
                    out[name] = {k: np.asarray(z[k]) for k in z.files}
            return out
        except Exception as e:  # corrupt/partial: caller falls back a step
            print(f"checkpoint: skipping unreadable step {step} "
                  f"({type(e).__name__}: {e})")
            return None

    def load_latest(
        self,
    ) -> Optional[Tuple[int, Dict[str, Dict[str, np.ndarray]]]]:
        """``(step, {tree: {leaf: array}})`` of the newest *readable*
        checkpoint, or ``None`` when the directory holds none.

        Walks steps newest-first, garbage-collecting ``step_*.tmp`` crash
        residue and skipping any checkpoint whose manifest is missing or
        whose sha256s don't verify — a run killed mid-save (or a partially
        synced directory) resumes from the last *good* state instead of
        crashing or reading garbage.  Arrays come back raw (the schema
        lives with the caller, e.g. ``EstimatorState.from_arrays``).  The
        returned step is protected from ``keep``-pruning for this manager's
        lifetime.
        """
        self._gc_tmp()
        for step in reversed(self.all_steps()):
            data = self._try_load(step)
            if data is not None:
                self._protected = step
                return step, data
        return None
