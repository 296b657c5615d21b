"""The port imports and synthesises where JAX, flax and orbax are absent,
as on the GPU machine: a fresh interpreter with the three blocked in
``sys.modules`` imports the pipeline and runs a tiny CPU synthesis, then
imports ``chip_smoke.py`` and every module it imports.  This also guards the
port's one tie to the reference: ``emojivoice_tpu/__init__.py``, run by the
port's ``config`` and ``apps.emoji``, must stay free of JAX."""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import sys
for name in ("jax", "flax", "orbax"):
    sys.modules[name] = None
import dataclasses
import numpy as np
import torch
torch.set_num_threads(1)
from emojivoice_tpu import config as cfglib
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline

model = cfglib.tiny().model
voc = cfglib.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
                           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))
pipe = SynthesisPipeline.from_random(cfglib.RootConfig(model=model, vocoder=voc), seed=0,
                                     mel_buckets=(64, 128, 256), text_buckets=(64, 128))
res = pipe.synthesise(["no jax here"], spks=[1], n_timesteps=2, seed=0, pcm16=True)[0]
assert res.mel_length > 0 and res.wav.shape == (res.mel_length * 16,), res.wav.shape
assert np.isfinite(res.wav).all()
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax")
                and sys.modules[m] is not None)
assert not loaded, loaded

import ast, importlib
import chip_smoke
tree = ast.parse(open("chip_smoke.py").read())
mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
assert "emojivoice_tpu_torch.kernels.build" in mods and "emojivoice_tpu_torch.apps.emoji" in mods, mods
for m in sorted(mods):
    importlib.import_module(m)
if not torch.cuda.is_available():
    assert chip_smoke.main() == 1  # no CPU path
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "orbax")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("OK", res.mel_length)
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.startswith("OK"), proc.stdout
