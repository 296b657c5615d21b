"""Checkpoints of a training run (PyTorch port of
``emojivoice_tpu.io.checkpoint``): ``torch.save`` of model, optimizer and
step, with the JSON config beside them, so a run can be re-instantiated
without the pickle's embedded hyperparameters.

One file per step, ``step_<n>.pt``, written to a temporary name and renamed,
so a crash never leaves a truncated checkpoint; the oldest are deleted
beyond ``max_to_keep``.

Over a process group of more than one rank (``sharded=True``; the JAX
package's orbax saves from every process) a step is a directory
``step_<n>.dcp`` of ``torch.distributed.checkpoint``: every rank calls
``save`` with its ``TrainState.sharded_state_dict()``, each writes its own
slices of the tensor-parallel tensors and the replicated ones are written
once; ``restore(template=)`` loads straight into such a state dict, each rank
reading its slices.  Rank 0 writes the config and prunes.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Any, List, Optional

import torch
import torch.distributed as dist

from emojivoice_tpu_torch import config as cfglib

_STEP_FILE = re.compile(r"^step_(\d+)\.(pt|dcp)$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 10, sharded: bool = False):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.sharded = sharded
        os.makedirs(self.directory, exist_ok=True)

    def is_sharded(self, step: int) -> bool:
        return os.path.isdir(os.path.join(self.directory, f"step_{int(step)}.dcp"))

    def _path(self, step: int) -> str:
        """The step's file or directory: what the step has, else what this manager writes."""
        one_file = os.path.join(self.directory, f"step_{int(step)}.pt")
        if self.is_sharded(step) or (self.sharded and not os.path.exists(one_file)):
            return os.path.join(self.directory, f"step_{int(step)}.dcp")
        return one_file

    def all_steps(self) -> List[int]:
        """Steps currently retained, ascending."""
        found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Any, cfg: Optional[cfglib.RootConfig] = None) -> None:
        """`state` is anything ``torch.save`` takes: the trainer passes
        ``{"model": state_dict, "optimizer": state_dict, "step": int}``; a
        sharded manager takes a ``sharded_state_dict()``, from every rank."""
        main = not self.sharded or dist.get_rank() == 0
        if cfg is not None and main:
            tmp = os.path.join(self.directory, ".config.json.tmp")
            cfglib.save_json(cfg, tmp)
            os.replace(tmp, os.path.join(self.directory, "config.json"))
        tmp = self._path(step) + ".tmp"
        if self.sharded:
            import torch.distributed.checkpoint as dcp

            dcp.save(state, checkpoint_id=tmp)
            dist.barrier()
        else:
            torch.save(state, tmp)
        if main:
            os.replace(tmp, self._path(step))
            if self.max_to_keep and self.max_to_keep > 0:
                for old in self.all_steps()[:-self.max_to_keep]:
                    if self.is_sharded(old):
                        shutil.rmtree(self._path(old))
                    else:
                        os.remove(self._path(old))
        if self.sharded:
            dist.barrier()  # no rank goes on before the step is in place

    def restore(self, step: Optional[int] = None, map_location="cpu", template: Optional[dict] = None) -> Any:
        """The saved state of `step` (the latest by default): a one-file
        step as ``torch.load`` gives it, a sharded one loaded in place into
        `template` (a ``sharded_state_dict()``), which is returned."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"No checkpoints in {self.directory}")
        path = self._path(step)
        if os.path.isdir(path):
            import torch.distributed.checkpoint as dcp

            if template is None:
                raise ValueError(f"{path} is a sharded checkpoint: restore it into a sharded_state_dict() template")
            dcp.load(template, checkpoint_id=path)
            return template
        return torch.load(path, map_location=map_location, weights_only=True)

    def load_config(self) -> cfglib.RootConfig:
        with open(os.path.join(self.directory, "config.json")) as f:
            return cfglib.from_dict(cfglib.RootConfig, json.load(f))
