"""Checkpoint / resume with wall-clock gating and runtime limits (a copy of
the JAX package's io/checkpoint.py without jax.tree_util).

The simulation state (phonon field, preconditioner, random generator state,
loop counters, metadata, partial-bin sums) is pickled with its tensors moved
to NumPy by a tree walk over dicts, lists and tuples; objects outside that
walk (the preconditioner) are pickled as they are. A new checkpoint is
written at most every `checkpoint_freq_hours` hours, into one of two
alternating slots, and the driver self-terminates past `runtime_limit_hours`
(tutorials/holstein_honeycomb_checkpoint.jl:383-416,516-540,693-700)."""

from __future__ import annotations

import glob
import os
import pickle
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..tree import tree_map


def _to_host(tree):
    return tree_map(lambda a: a.cpu().numpy() if isinstance(a, torch.Tensor) else a, tree)


def checkpoint_path(datafolder: str, pID: int = 0, slot: int = 0) -> str:
    return os.path.join(datafolder, f"checkpoint_pID-{pID}_slot-{slot}.pkl")


def write_checkpoint(
    datafolder: str,
    state_tree: Dict[str, Any],
    pID: int = 0,
    checkpoint_timestamp: Optional[float] = None,
    checkpoint_freq_hours: float = 0.0,
    start_timestamp: Optional[float] = None,
    runtime_limit_hours: float = np.inf,
) -> Optional[float]:
    """Write a checkpoint if one is due. Returns the new checkpoint timestamp
    (or the old one when skipped). Two alternating slots protect against
    truncation on interruption."""
    now = time.time()
    if checkpoint_timestamp is not None and (now - checkpoint_timestamp) < checkpoint_freq_hours * 3600.0:
        return checkpoint_timestamp
    payload = {
        "state": _to_host(state_tree),
        "timestamp": now,
        "pID": pID,
    }
    slot = int(now) % 2
    path = checkpoint_path(datafolder, pID, slot)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)
    return now


def read_checkpoint(datafolder: str, pID: int = 0) -> Optional[Dict[str, Any]]:
    """Load the most recent valid checkpoint, or None."""
    candidates = sorted(
        glob.glob(os.path.join(datafolder, f"checkpoint_pID-{pID}_slot-*.pkl")),
        key=os.path.getmtime,
        reverse=True,
    )
    for path in candidates:
        try:
            with open(path, "rb") as f:
                return pickle.load(f)
        except (OSError, EOFError, pickle.UnpicklingError):
            continue
    return None


def delete_checkpoints(datafolder: str, pID: Optional[int] = None) -> None:
    pat = f"checkpoint_pID-{pID}_slot-*.pkl" if pID is not None else "checkpoint_pID-*_slot-*.pkl"
    for path in glob.glob(os.path.join(datafolder, pat)):
        os.remove(path)


def checkpoint_due(checkpoint_timestamp: Optional[float], checkpoint_freq_hours: float) -> bool:
    if checkpoint_timestamp is None:
        return True
    return (time.time() - checkpoint_timestamp) >= checkpoint_freq_hours * 3600.0


def runtime_exceeded(start_timestamp: float, runtime_limit_hours: float) -> bool:
    return (time.time() - start_timestamp) >= runtime_limit_hours * 3600.0
