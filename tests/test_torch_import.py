"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package, as on the GPU machine where neither need exist.

A fresh interpreter imports every module of ``emojivoice_tpu_torch`` and
everything ``chip_smoke.py`` imports, runs a tiny CPU synthesis and a
``--fast_dev_run`` of the trainer, and then ``sys.modules`` must hold no
``emojivoice_tpu`` (or ``emojivoice_tpu.*``) and none of jax, jaxlib, flax,
optax, orbax.  A second test holds the port's own copies of the presets and
the emoji mapping equal to the JAX package's, so they cannot drift unnoticed.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

SCRIPT = r"""
import ast, importlib, pkgutil, sys, tempfile
from pathlib import Path
import numpy as np
import torch
torch.set_num_threads(1)

FOREIGN = ("jax", "jaxlib", "flax", "optax", "orbax", "emojivoice_tpu")
def foreign():
    return sorted(m for m in sys.modules if m.split(".")[0] in FOREIGN)

import emojivoice_tpu_torch
names = [m.name for m in pkgutil.walk_packages(emojivoice_tpu_torch.__path__, "emojivoice_tpu_torch.")]
for want in ("ops.mas", "ops.mel", "data.dataset", "data.audio_np", "training.train", "training.state",
             "training.synthetic", "io.checkpoint", "io.from_jax", "kernels.build", "config", "apps.emoji"):
    assert "emojivoice_tpu_torch." + want in names, want
for name in names:
    importlib.import_module(name)
assert not foreign(), foreign()

from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
model = cfglib.tiny().model
voc = cfglib.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
                           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))
pipe = SynthesisPipeline.from_random(cfglib.RootConfig(model=model, vocoder=voc), seed=0, device="cpu",
                                     mel_buckets=(64, 128, 256), text_buckets=(64, 128))
res = pipe.synthesise(["no jax here"], spks=[1], n_timesteps=2, seed=0, pcm16=True)[0]
assert res.mel_length > 0 and res.wav.shape == (res.mel_length * 16,), res.wav.shape
assert np.isfinite(res.wav).all()

from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset
from emojivoice_tpu_torch.training.train import main
with tempfile.TemporaryDirectory() as tmp:
    train, val, _ = make_alignable_dataset(Path(tmp), [0, 1], n_utts=2, seed=0)
    assert main(["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
                 "--out_dir", tmp + "/run", "--batch_size", "2", "--fast_dev_run"]) == 0

import chip_smoke
tree = ast.parse(open("chip_smoke.py").read())
mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
for want in ("emojivoice_tpu_torch.kernels.build", "emojivoice_tpu_torch.apps.emoji", "emojivoice_tpu_torch.ops",
             "emojivoice_tpu_torch.training"):
    assert want in mods, (want, mods)
for m in sorted(mods):
    importlib.import_module(m)
if not torch.cuda.is_available():
    assert chip_smoke.main() == 1  # no CPU path
assert not foreign(), foreign()
print("OK", res.mel_length, len(names))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", SCRIPT], cwd=str(REPO), env=env, capture_output=True,
                          text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.splitlines()[-1].startswith("OK"), proc.stdout


def test_port_sources_name_no_import_of_the_jax_package():
    files = sorted((REPO / "emojivoice_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 30
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            code = line.split("#")[0]
            for bad in ("import emojivoice_tpu.", "import emojivoice_tpu ", "from emojivoice_tpu.",
                        "from emojivoice_tpu ", "import jax", "from jax", "import flax", "import optax",
                        "import orbax"):
                assert bad not in code + " ", f"{path.relative_to(REPO)}:{n}: {line.strip()}"


@pytest.mark.parametrize("name", ["ljspeech", "vctk", "emoji_multi", "tiny"])
def test_presets_equal_the_jax_packages(name):
    from emojivoice_tpu import config as theirs
    from emojivoice_tpu_torch import config as ours

    assert ours.to_dict(ours.get_preset(name)) == theirs.to_dict(theirs.get_preset(name))
    assert sorted(ours.PRESETS) == sorted(theirs.PRESETS)
    # the copy's own machinery: JSON round trip and dotted-path overrides
    root = ours.get_preset(name, **{"model.out_size": 172, "optimizer.lr": 3e-4})
    assert root.model.out_size == 172 and root.optimizer.lr == 3e-4
    assert ours.from_dict(ours.RootConfig, ours.to_dict(root)) == root
    for cls in ("EncoderConfig", "DecoderConfig", "ModelConfig", "DataConfig", "OptimizerConfig", "TrainerConfig",
                "HiFiGANConfig", "AudioConfig", "CFMConfig", "DurationPredictorConfig", "DataStatistics"):
        a, b = getattr(ours, cls), getattr(theirs, cls)
        assert [(f.name, f.default) for f in dataclasses.fields(a) if f.default is not dataclasses.MISSING] == \
               [(f.name, f.default) for f in dataclasses.fields(b) if f.default is not dataclasses.MISSING], cls


def test_emoji_mapping_equals_the_jax_packages():
    from emojivoice_tpu.apps import emoji as theirs
    from emojivoice_tpu_torch.apps import emoji as ours

    assert ours.EMOJI_MAPPING == theirs.EMOJI_MAPPING and len(ours.EMOJI_MAPPING) == 11
    assert ours.EMOJI_MAPPING_MALE == theirs.EMOJI_MAPPING_MALE
    reply = "That's great! 😎 (really)"
    assert ours.parse_emoji_response(reply) == theirs.parse_emoji_response(reply) == (79, "That's great!  really")
