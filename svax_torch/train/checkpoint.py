"""Checkpoint/resume on ``torch.save`` (``svax/train/checkpoint.py``).

Persists the whole training state — NN params, Adam moments and count, the
PGM naturals, the step counter — and the run's generator state, and
restores them exactly, so an interrupted run resumes bit for bit.

A checkpoint is one file a step, ``<directory>/step_<step>.pt``, holding a
flat dict of tensors keyed by each leaf's path in the state's NamedTuples,
dicts and lists (``utils.tree``: ``nn_params.encoder.0.w``,
``opt_state.count``, ``pgm_nat.niw_nat.eta3``, ``step``); Python ints and
floats are stored as 0-d tensors. It is written under a temporary name and
renamed into place (``os.replace``), so a reader never sees half a file,
and only the newest ``max_to_keep`` steps are kept. Restoring loads with
``weights_only=True`` (no pickled classes) into the caller's template: a
template whose paths, shapes or dtypes differ from the file raises, and
nothing is loaded in part.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Any

import torch

from svax_torch.utils.tree import flatten, unflatten

_FILE = re.compile(r"^step_(\d+)\.pt$")


def _as_tensor(path: str, leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu()
    if isinstance(leaf, (bool, int)):
        return torch.tensor(int(leaf), dtype=torch.int64)
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float64)
    raise TypeError(f"checkpoint: leaf {path!r} is a {type(leaf).__name__}, "
                    "not a tensor or a number")


def _spec(path: str, leaf) -> tuple:
    """(shape, dtype) that ``_as_tensor`` gives ``leaf``, without a copy."""
    if isinstance(leaf, torch.Tensor):
        return tuple(leaf.shape), leaf.dtype
    t = _as_tensor(path, leaf)
    return tuple(t.shape), t.dtype


def _rng_state(rng) -> torch.Tensor | None:
    if rng is None or isinstance(rng, torch.Tensor):
        return rng
    return rng.get_state()


class Checkpointer:
    """Save and restore state trees in ``directory`` (made if missing)."""

    def __init__(self, directory: str | Path, max_to_keep: int = 3):
        self._dir = Path(directory).resolve()
        self._dir.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self._dir / f"step_{step}.pt"

    def all_steps(self) -> list[int]:
        """The saved steps, oldest first."""
        return sorted(int(m.group(1)) for m in map(_FILE.match, os.listdir(self._dir)) if m)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, rng=None) -> None:
        """Write ``state`` as step ``step``; ``rng`` is a ``torch.Generator``
        (its ``get_state()`` is saved), a generator state tensor, or None."""
        payload = {
            "state": {path: _as_tensor(path, leaf) for path, leaf in flatten(state)},
            "rng": _rng_state(rng),
        }
        final = self._path(int(step))
        tmp = final.with_name(final.name + ".tmp")
        torch.save(payload, tmp)
        os.replace(tmp, final)
        for old in self.all_steps()[:-self.max_to_keep]:
            self._path(old).unlink(missing_ok=True)

    def restore_or(self, state: Any, rng=None):
        """Return (state, rng, start_step): the latest checkpoint restored
        into ``state``'s structure, devices and leaf types, or ``state`` and
        ``rng`` themselves with start 0 when the directory holds none. A
        ``torch.Generator`` given as ``rng`` gets the saved state set on it
        and is returned; a state tensor is replaced by the saved one."""
        latest = self.latest_step()
        if latest is None:
            return state, rng, 0
        path = self._path(latest)
        payload = torch.load(path, map_location="cpu", weights_only=True)
        saved = payload["state"]
        leaves = flatten(state)
        want = [p for p, _ in leaves]
        if set(want) != set(saved):
            missing = sorted(set(want) - set(saved))[:5]
            extra = sorted(set(saved) - set(want))[:5]
            raise ValueError(f"checkpoint {path}: the template's leaves differ from the "
                             f"file's (not in the file: {missing}; not in the template: "
                             f"{extra})")
        restored = []
        for p, leaf in leaves:
            t = saved[p]
            shape, dtype = _spec(p, leaf)
            if tuple(t.shape) != shape or t.dtype != dtype:
                raise ValueError(f"checkpoint {path}: {p} is {t.dtype}{list(t.shape)} in the "
                                 f"file and {dtype}{list(shape)} in the template")
            if isinstance(leaf, torch.Tensor):
                restored.append(t.to(leaf.device))
            else:
                restored.append(type(leaf)(t.item()))
        new_rng = payload["rng"]
        if rng is not None and new_rng is None:
            raise ValueError(f"checkpoint {path} holds no generator state")
        if isinstance(rng, torch.Generator):
            rng.set_state(new_rng)
            new_rng = rng
        elif rng is None:
            new_rng = None
        return unflatten(state, restored), new_rng, latest

    def close(self) -> None:
        """Nothing is held open between calls; kept for the reference's API."""
