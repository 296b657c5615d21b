"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package, as on the GPU machine where neither need exist.

A fresh interpreter imports every module of ``emojivoice_tpu_torch`` and
everything ``chip_smoke.py`` imports, runs a tiny CPU synthesis, the serving
front ends on it (batching engine, streaming vocoder, long-form, the CLI, the
webapp over HTTP, a checkpoint written and served), a ``--fast_dev_run`` of
the trainer, and the vocoder's training side with its tools (data statistics,
export, ``--from_torch_ckpt``, durations and teacher-forced mels, two GAN
steps), and then ``sys.modules`` must hold no
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
             "training.synthetic", "io.checkpoint", "io.from_jax", "kernels.build", "config", "apps.emoji",
             "inference.serving", "inference.streaming", "inference.longform", "inference.cli", "apps.webapp",
             "io.torch_ckpt", "utils.assets", "vocoder.discriminators", "training.vocoder_train",
             "training.vocoder_proof", "training.proof", "training.get_durations", "data.stats", "io.export_torch"):
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

# the serving front ends, each run once on the tiny pipeline
import json, threading, urllib.request
from emojivoice_tpu_torch.apps import webapp
from emojivoice_tpu_torch.inference import cli
from emojivoice_tpu_torch.inference.longform import synthesise_longform
from emojivoice_tpu_torch.inference.serving import BatchingEngine
from emojivoice_tpu_torch.inference.streaming import auto_stream
from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
from emojivoice_tpu_torch.utils.assets import resolve_model
with BatchingEngine(pipe, max_batch=2, max_wait_ms=50) as eng:
    futs = [eng.submit(f"engine {i}", spk=i, n_timesteps=2) for i in range(2)]
    assert all(f.result(timeout=120).mel_length > 0 for f in futs)
assert sum(len(c) for c in auto_stream(pipe, "streamed", spk=1, n_timesteps=2, seed=0, strategy="stream")) > 0
assert synthesise_longform(pipe, "One sentence. Two sentences.", spk=1, max_chars=15, n_timesteps=2).size > 0
server = webapp.serve(pipe, port=0, batching=True, max_batch=2, max_wait_ms=5)
threading.Thread(target=server.serve_forever, daemon=True).start()
url = f"http://127.0.0.1:{server.server_address[1]}"
req = urllib.request.Request(url + "/api/synthesise", data=json.dumps({"text": "over http", "steps": 2}).encode(),
                             headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req, timeout=120) as r:
    assert json.loads(r.read())["num_samples"] > 0
req = urllib.request.Request(url + "/api/stream", data=json.dumps({"text": "over http", "steps": 2}).encode(),
                             headers={"Content-Type": "application/json"})
with urllib.request.urlopen(req, timeout=120) as r:
    assert len(r.read()) > 44
server.shutdown(); server.server_close(); server.engine.close()
with tempfile.TemporaryDirectory() as tmp:
    CheckpointManager(tmp + "/ckpts").save(3, {"model": pipe.model.state_dict(), "step": 3},
                                          cfg=cfglib.RootConfig(model=model, vocoder=voc))
    served = SynthesisPipeline.from_checkpoint(resolve_model(tmp + "/ckpts"), device="cpu",
                                               mel_buckets=(64, 128, 256), text_buckets=(64, 128))
    assert served.synthesise(["served"], spks=[1], n_timesteps=2, seed=0)[0].mel_length > 0
    torch.save({"state_dict": pipe.model.state_dict()}, tmp + "/voice.ckpt")
    torch.save({"generator": pipe.vocoder.state_dict()}, tmp + "/generator")
    loaded = SynthesisPipeline.from_torch_checkpoints(tmp + "/voice.ckpt", tmp + "/generator", vocoder_cfg=voc,
                                                      device="cpu", mel_buckets=(64, 128, 256), text_buckets=(64, 128))
    assert loaded.model_cfg.n_spks == model.n_spks
    SynthesisPipeline.from_random = classmethod(lambda cls, **kw: pipe)  # the CLI's preset is full width
    assert cli.main(["--cpu", "--random_init", "--text", "from the cli", "--steps", "2", "--output_folder", tmp]) == 0
    assert list(Path(tmp).glob("utterance_*.wav"))
assert not foreign(), foreign()

from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset
from emojivoice_tpu_torch.training.train import main
with tempfile.TemporaryDirectory() as tmp:
    train, val, _ = make_alignable_dataset(Path(tmp), [0, 1], n_utts=2, seed=0)
    assert main(["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
                 "--out_dir", tmp + "/run", "--batch_size", "2", "--fast_dev_run"]) == 0

# the vocoder's training side and the tools around it: every console script's main, once, at a tiny size
import tomllib
scripts = tomllib.load(open("pyproject.toml", "rb"))["project"]["scripts"]
ported = {k: v for k, v in scripts.items() if v.startswith("emojivoice_tpu_torch.")}
for want in ("emojivoice-get-durations-torch", "emojivoice-data-stats-torch", "emojivoice-export-torch-torch",
             "emojivoice-train-proof-torch", "emojivoice-vocoder-proof-torch"):
    assert want in ported, (want, sorted(ported))
for target in ported.values():
    mod, fn = target.split(":")
    assert callable(getattr(importlib.import_module(mod), fn)), target
from emojivoice_tpu_torch.data import stats
from emojivoice_tpu_torch.io import export_torch
from emojivoice_tpu_torch.training import get_durations, proof, vocoder_proof
narrow = cfglib.HiFiGANConfig(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=16,
                              resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),))
with tempfile.TemporaryDirectory() as tmp:
    train, val = proof.make_dataset(Path(tmp) / "data", (0, 1), n_utts=3, seconds=1.0, seed=0)
    assert stats.main(["--filelist", str(train), "--preset", "tiny"]) == 0
    assert main(["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
                 "--out_dir", tmp + "/run", "--batch_size", "2", "--max_steps", "1", "--val_every_steps", "0"]) == 0
    assert export_torch.main(["--ckpt_dir", tmp + "/run/ckpts", "--output", tmp + "/voice.ckpt"]) == 0
    assert main(["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
                 "--out_dir", tmp + "/ft", "--batch_size", "2", "--fast_dev_run", "--from_torch_ckpt",
                 tmp + "/voice.ckpt"]) == 0
    assert get_durations.main(["--checkpoint_path", tmp + "/voice.ckpt", "--filelist", str(train), "--preset", "tiny",
                               "--output_dir", tmp + "/durs", "--device", "cpu", "--gen_mels", "--n_timesteps", "1"]) == 0
    # two steps: the harness's own mel-L1 assert may or may not hold at this size, its path is what runs here
    try:
        vocoder_proof.run_vocoder_proof(tmp + "/voc", steps=2, batch_size=1, segment_frames=8, cfg=narrow,
                                        filelist=str(train), gen_mels_dir=tmp + "/durs/gen_mels", device="cpu")
    except AssertionError as e:
        assert "mel L1 did not decrease" in str(e), e
    assert (Path(tmp) / "voc" / "after.wav").exists() and (Path(tmp) / "voc" / "g_00000002").exists()
assert not foreign(), foreign()

import chip_smoke
tree = ast.parse(open("chip_smoke.py").read())
mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
for want in ("emojivoice_tpu_torch.kernels.build", "emojivoice_tpu_torch.apps.emoji", "emojivoice_tpu_torch.ops",
             "emojivoice_tpu_torch.training", "emojivoice_tpu_torch.inference.serving",
             "emojivoice_tpu_torch.training.vocoder_proof", "emojivoice_tpu_torch.training.vocoder_train",
             "emojivoice_tpu_torch.inference.streaming", "emojivoice_tpu_torch.inference", "emojivoice_tpu_torch.apps"):
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
