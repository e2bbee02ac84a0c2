"""Atomic, checksummed, asynchronous checkpoints of dicts of arrays.

Counterpart of ``repro/train/checkpoint.py`` (DESIGN.md §7, §16):

* **atomic** — writes go to ``step_XXXX.tmp/`` and are renamed only after a
  manifest with content checksums is fsynced; a crash mid-save never
  corrupts the latest checkpoint (the ``checkpoint.write_crash`` fault site
  kills the writer between the two);
* **async** — with ``async_save=True`` ``save`` copies the tensors to the
  host, then a writer thread writes them while the caller goes on
  (``save(..., block=True)`` writes before returning).  The train loop asks
  for it, as the reference's gets it from its default.  The port's default
  is synchronous, where the reference's is async: its counting callers
  (which pass ``async_save=False`` in the reference) and their tests build
  the manager bare, and "killed after the save at call N" must stay a
  well-defined resume point;
* **bounded** — keeps the last ``keep`` checkpoints, never the one a run
  was restored from.

A tree is a nested dict of tensors or numpy arrays (``{"params": {...},
"opt": {"m": {...}, "v": {...}, "step": ...}}``); each named tree is one
``.npz``, flattened by path (``"m/blocks.0.ln1"``).  ``restore`` loads a
checkpoint onto tensors shaped like templates, on their devices, checking
shapes and checksums; ``load_latest`` returns the newest readable one raw.

On a mesh the train loop gathers each leaf whole and one rank saves, so
the format is the same from any mesh; ``restore(..., shardings=)`` gives
each rank its block (a :class:`~repro_torch.comm.spec.Placement` a leaf),
so a checkpoint restores onto a mesh of any shape, or onto one device.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..testing import faults

__all__ = ["CheckpointManager"]


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested dict of tensors or arrays as ``{"a/b": host array}``, each a
    copy: the caller may update its tensors in place (a train step does)
    while the writer thread writes."""
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key + "/"))
        elif isinstance(v, torch.Tensor):
            flat[key] = v.detach().to("cpu", copy=True).numpy()
        else:
            flat[key] = np.array(v)
    return flat


def _unflatten(template: Mapping, flat, name: str, prefix: str = "",
               shardings: Optional[Mapping] = None) -> Dict[str, Any]:
    """Tensors shaped like ``template``'s leaves, on their devices and in
    their dtypes, from the flat arrays (each cut to its block where
    ``shardings``, shaped like ``template``, places it); a shape mismatch
    raises."""
    out = {}
    for k, leaf in template.items():
        key = f"{prefix}{k}"
        place = None if shardings is None else shardings.get(k)
        if isinstance(leaf, Mapping):
            out[k] = _unflatten(leaf, flat, name, key + "/", place)
            continue
        arr = torch.from_numpy(np.array(flat[key]))
        if place is not None:
            arr = place.block(arr)
        if tuple(arr.shape) != tuple(leaf.shape):
            raise ValueError(f"{name}:{key} shape {tuple(arr.shape)} != template "
                             f"{tuple(leaf.shape)}")
        out[k] = arr.to(device=leaf.device, dtype=leaf.dtype, copy=True)
    return out


def _digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3, async_save: bool = False):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        #: the step load_latest()/restore() last read: keep-pruning never
        #: deletes the checkpoint a live run was restored from
        self._protected: Optional[int] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, trees: Mapping[str, Mapping], *, block: bool = False):
        """``trees``: name -> nested dict of tensors or arrays (e.g.
        ``{"estimator": state.to_arrays()}``, ``{"params": ..., "opt":
        ...}``).  The host copies are made here; the write runs on the
        writer thread unless ``block`` or ``async_save=False``."""
        host = {name: _flatten(t) for name, t in trees.items()}
        self.wait()
        if self.async_save and not block:
            self._thread = threading.Thread(target=self._write, args=(step, host), daemon=True)
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host: Dict[str, Dict[str, np.ndarray]]):
        self._gc_tmp()  # crash residue from a previously killed writer
        tmp = os.path.join(self.dir, f"step_{step:08d}.tmp")
        final = os.path.join(self.dir, f"step_{step:08d}")
        os.makedirs(tmp)
        manifest = {"step": step, "time": time.time(), "trees": {}}
        for name, flat in host.items():
            path = os.path.join(tmp, f"{name}.npz")
            np.savez(path, **flat)
            manifest["trees"][name] = {"file": f"{name}.npz", "sha256": _digest(path)}
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

    def wait(self):
        """Join the writer thread, if one is writing."""
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            if s == self._protected:
                continue  # never delete the checkpoint a run restored from
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"), ignore_errors=True)

    def _gc_tmp(self):
        """Remove ``step_*.tmp`` residue left by a killed writer: its
        rename never happened, so it can never become a valid checkpoint.
        Only called with no writer thread in flight (``save`` joins the last
        writer first, ``load_latest`` waits too)."""
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
                if _digest(path) != meta["sha256"]:
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
        self.wait()
        self._gc_tmp()
        for step in reversed(self.all_steps()):
            data = self._try_load(step)
            if data is not None:
                self._protected = step
                return step, data
        return None

    def restore(self, step: int, templates: Mapping[str, Mapping], *,
                shardings: Optional[Mapping[str, Mapping]] = None,
                verify: bool = True) -> Dict[str, Any]:
        """The trees of checkpoint ``step``, shaped like ``templates`` (name ->
        nested dict of tensors): each leaf a new tensor on its template's
        device, in its dtype.  ``shardings`` (name -> a tree like the
        template's of ``Placement``s) re-shards onto a mesh: each leaf is the
        rank's block of the saved one, and the template holds the blocks'
        shapes.  A checksum that does not verify raises ``IOError``, a shape
        that differs from the template's ``ValueError``."""
        self.wait()
        base = os.path.join(self.dir, f"step_{step:08d}")
        self._protected = step  # keep-pruning must not delete it mid-restore
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        out = {}
        for name, template in templates.items():
            meta = manifest["trees"][name]
            path = os.path.join(base, meta["file"])
            if verify and _digest(path) != meta["sha256"]:
                raise IOError(f"checksum mismatch for {name} at step {step}")
            with np.load(path, allow_pickle=False) as z:
                out[name] = _unflatten(template, z, name,
                                       shardings=None if shardings is None
                                       else shardings.get(name))
        return out
