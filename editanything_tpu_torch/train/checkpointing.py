"""Checkpoint and resume for training, as torch files.

Counterpart of ``editanything_tpu/train/checkpointing.py``, with its
interface (``CheckpointManager``: ``maybe_save``, ``save``,
``latest_step``, ``restore``, ``close``, retention by ``max_to_keep``;
``save_params``, ``load_params``) and another format on purpose: where the
JAX package writes orbax directories, each step here is one file
``<directory>/step_<step>.pt`` of plain tensors, numbers and dicts, which
``torch.load(..., weights_only=True)`` reads back. A train state (its
``state_dict()``) holds the parameters, the optimizer's ``state_dict``, the
step and the EMA. The port reads its own checkpoints, not orbax's.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

from editanything_tpu_torch.train.logging import is_main_process

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    """Save and restore train states (anything with ``state_dict`` and
    ``load_state_dict``, or a plain dict of tensors) by step, keeping the
    newest ``max_to_keep``. Under data parallelism every rank restores and
    takes the state to save, and only the main one (`is_main`, default
    rank 0 of an initialised ``torch.distributed``) writes."""

    def __init__(self, directory: str, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1000,
                 is_main: Optional[bool] = None):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.is_main = is_main_process() if is_main is None else is_main
        if self.is_main:
            os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def all_steps(self):
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(
            _STEP_FILE.match, os.listdir(self.directory)) if m)

    def maybe_save(self, step: int, state) -> bool:
        """Save if `step` hits the interval. Returns True if saved."""
        if step % self.save_interval_steps != 0:
            return False
        self.save(step, state)
        return True

    def save(self, step: int, state) -> None:
        """Write the step's file (through a temporary name, so a cut write
        leaves no partial checkpoint), then drop the oldest beyond
        ``max_to_keep``. Every rank takes the state's ``state_dict`` (on a
        mesh it gathers: a collective); only the main one writes."""
        sd = state.state_dict() if hasattr(state, "state_dict") else state
        if not self.is_main:
            return
        tmp = self._path(step) + ".tmp"
        torch.save(sd, tmp)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep]:
            os.remove(self._path(old))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: Optional[int] = None):
        """Load the step's file (the latest by default) into `state_like`
        (``load_state_dict``) and return it; a plain dict comes back as
        read. None when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        sd = torch.load(self._path(step), map_location="cpu", weights_only=True)
        if hasattr(state_like, "load_state_dict"):
            state_like.load_state_dict(sd)
            return state_like
        return sd

    def close(self):
        """Nothing is pending: every save is written when it returns."""


def save_params(path: str, params) -> None:
    """One-shot save of a module's parameters or a dict of tensors."""
    sd = params.state_dict() if hasattr(params, "state_dict") else params
    torch.save({k: v.detach().cpu() for k, v in sd.items()}, path)


def load_params(path: str, params_like):
    """Load `path` into a module (strict) and return it, or return the dict
    of tensors when `params_like` is None or a dict."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(params_like, "load_state_dict"):
        params_like.load_state_dict(sd, strict=True)
        return params_like
    return sd
