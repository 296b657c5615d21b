"""Checkpoints of a training run (PyTorch port of
``emojivoice_tpu.io.checkpoint``): ``torch.save`` of model, optimizer and
step, with the JSON config beside them, so a run can be re-instantiated
without the pickle's embedded hyperparameters.

One file per step, ``step_<n>.pt``, written to a temporary name and renamed,
so a crash never leaves a truncated checkpoint; the oldest are deleted
beyond ``max_to_keep``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, List, Optional

import torch

from emojivoice_tpu_torch import config as cfglib

_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        """Steps currently retained, ascending."""
        found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, cfg: Optional[cfglib.RootConfig] = None) -> None:
        """`state` is anything ``torch.save`` takes: the trainer passes
        ``{"model": state_dict, "optimizer": state_dict, "step": int}``."""
        if cfg is not None:
            tmp = os.path.join(self.directory, ".config.json.tmp")
            cfglib.save_json(cfg, tmp)
            os.replace(tmp, os.path.join(self.directory, "config.json"))
        tmp = self._path(step) + ".tmp"
        torch.save(state, tmp)
        os.replace(tmp, self._path(step))
        if self.max_to_keep and self.max_to_keep > 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self._path(old))

    def restore(self, step: Optional[int] = None, map_location="cpu") -> Any:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        return torch.load(self._path(step), map_location=map_location, weights_only=True)

    def load_config(self) -> cfglib.RootConfig:
        with open(os.path.join(self.directory, "config.json")) as f:
            return cfglib.from_dict(cfglib.RootConfig, json.load(f))
