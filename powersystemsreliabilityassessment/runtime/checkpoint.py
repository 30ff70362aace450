"""Convergence-loop checkpointing (preemption recovery).

The reference saves results only at completion (nsqMain.m:404-405,
seqMain.m:261-262); mid-run state is lost on failure. Here the tiny host
accumulator state (float64 moments, histories, batch counter — the PRNG key
is derived from (seed, batch_idx), so no device state needs saving) is
atomically written every K batches; restarting a study resumes exactly.
"""
from __future__ import annotations

import json
import os
import tempfile

import numpy as np


def _to_jsonable(obj):
    if isinstance(obj, np.ndarray):
        return {"__ndarray__": obj.tolist()}
    if isinstance(obj, (np.floating, np.integer)):
        return float(obj)
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(v) for v in obj]
    return obj


def _from_jsonable(obj):
    if isinstance(obj, dict):
        if "__ndarray__" in obj:
            return np.asarray(obj["__ndarray__"], dtype=np.float64)
        return {k: _from_jsonable(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_from_jsonable(v) for v in obj]
    return obj


class Checkpointer:
    """Atomic JSON checkpointing of host accumulator state."""

    def __init__(self, path: str):
        self.path = path

    def save(self, state: dict) -> None:
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".",
                                   suffix=".ckpt.tmp")
        with os.fdopen(fd, "w") as f:
            json.dump(_to_jsonable(state), f)
        os.replace(tmp, self.path)

    def restore(self) -> dict | None:
        if not os.path.exists(self.path):
            return None
        with open(self.path) as f:
            return _from_jsonable(json.load(f))

    def clear(self) -> None:
        if os.path.exists(self.path):
            os.remove(self.path)


class OrbaxCheckpointer:
    """Orbax-backed checkpointer with the same save/restore/clear API.

    Drop-in alternative to the JSON :class:`Checkpointer` for
    multi-host/cloud-storage deployments: orbax writes atomically
    (tmp-dir + rename), supports GCS-style paths, and scales to large
    array state. For the tiny accumulator states here the JSON backend is
    equally correct; both restore into the same study-loop logic.

    ``path`` is a DIRECTORY (orbax checkpoints are directories, unlike
    the JSON file backend).
    """

    def __init__(self, path: str):
        try:
            import orbax.checkpoint as ocp
        except ImportError as e:
            raise ImportError(
                "the orbax checkpoint backend needs the 'orbax-checkpoint' "
                "package; install it or use the JSON backend") from e

        self.path = os.path.abspath(path)
        self._ckptr = ocp.PyTreeCheckpointer()

    def save(self, state: dict) -> None:
        # Orbax treats Python lists as pytree branches; history lists of
        # floats round-trip as lists of scalars, which is what the study
        # loops expect.
        self._ckptr.save(self.path, _to_jsonable(state), force=True)

    def restore(self) -> dict | None:
        if not os.path.isdir(self.path):
            return None
        return _from_jsonable(self._ckptr.restore(self.path))

    def clear(self) -> None:
        import shutil

        if os.path.isdir(self.path):
            shutil.rmtree(self.path)
