"""The port stands alone: it imports nothing of JAX and nothing of the JAX
package, as on the GPU machine where neither need exist.

A fresh interpreter imports every module of ``emojivoice_tpu_torch`` and
everything ``chip_smoke.py`` imports, runs a tiny CPU synthesis, the serving
front ends on it (batching engine, streaming vocoder, long-form, the CLI, the
webapp over HTTP, a checkpoint written and served, a bundle exported and
run), a conformer model's synthesis, the apps (one agent turn from a recorded
wav through Whisper and a causal LM built from transformers' PyTorch classes,
a story rendered and relayed, the recording tools), a ``--fast_dev_run`` of the trainer and
a run with its loggers and a validation render, a sweep of it in process, a
short scratch proof, and the vocoder's training side with its tools (data
statistics, export, ``--from_torch_ckpt``, durations and teacher-forced mels,
two GAN steps through the captured step's staging), and then ``sys.modules`` must hold no
``emojivoice_tpu`` (or ``emojivoice_tpu.*``) and none of jax, jaxlib, flax,
optax, orbax.  A second test holds the port's own copies of the presets and
the emoji mapping equal to the JAX package's, a third the apps' host-side
copies (every top-level name but the ones that differ on purpose), and a
fourth the parallel slice's (the batch padding and the process-shard
batching), so they cannot drift unnoticed
(the port's copies of ``utils/observability.py`` and ``training/sweep.py`` are
held to the originals by ``tests/test_torch_observability.py`` and
``tests/test_torch_sweep.py``).
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
             "inference.graphs", "training.vocoder_graphs",
             "io.torch_ckpt", "utils.assets", "vocoder.discriminators", "training.vocoder_train",
             "training.vocoder_proof", "training.proof", "training.get_durations", "data.stats", "io.export_torch",
             "inference.export", "io.torch_pickle", "models.conformer", "utils.observability",
             "training.scratch_proof", "training.sweep", "apps.adapters", "apps.torch_adapters", "apps.decode",
             "apps.feel_me", "apps.game_ui", "apps.demos", "apps.pepper", "apps.record_audio", "parallel.mesh",
             "parallel.tp",
             "bench.util", "bench.synthesis", "bench.breakdown", "bench.serving", "bench.ttfa", "bench.exported",
             "bench.vocoder", "bench.vocoder_stages", "bench.mas", "bench.train", "bench.mfu", "bench.multilingual"):
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
# the graph path's staging (inference/graphs.py; nothing is captured on the CPU)
staged = SynthesisPipeline.from_random(cfglib.RootConfig(model=model, vocoder=voc), seed=0, device="cpu",
                                       mel_buckets=(64, 128, 256), text_buckets=(64, 128), graphs=True)
assert np.array_equal(staged.synthesise(["no jax here"], spks=[1], n_timesteps=2, seed=0, pcm16=True)[0].wav, res.wav)
# the conformer decoder: a tiny synthesis with every block type conformer
import dataclasses
conf = dataclasses.replace(model, decoder=dataclasses.replace(
    model.decoder, down_block_type="conformer", mid_block_type="conformer", up_block_type="conformer"))
from emojivoice_tpu_torch.models.matcha import MatchaTTS
conf_pipe = SynthesisPipeline(conf, MatchaTTS(conf, strict_mask=True), voc, pipe.vocoder, device="cpu",
                              mel_buckets=(64, 128, 256), text_buckets=(64, 128))
assert conf_pipe.synthesise(["a conformer"], spks=[1], n_timesteps=2, seed=0)[0].mel_length > 0
assert not foreign(), foreign()

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
from emojivoice_tpu_torch.inference.export import LoadedBundle, export_bundle
with tempfile.TemporaryDirectory() as tmp:
    export_bundle(pipe, tmp, text_buckets=[64], mel_buckets=[64], batches=(1,), n_timesteps=2)
    assert LoadedBundle(tmp, device="cpu").synthesise(["exported"], spks=[1], seed=0)[0][0]["mel_length"] > 0
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


# the apps: Whisper and a causal LM through transformers' PyTorch classes (tiny configs), one agent turn over them
# from a recorded wav, a story rendered and relayed, the recording tools
from scipy.io import wavfile
from emojivoice_tpu_torch.apps import adapters as ad, demos, pepper, record_audio
from emojivoice_tpu_torch.apps.feel_me import FeelMe
from emojivoice_tpu_torch.apps.torch_adapters import TorchChatLM, TorchWhisperASR, import_transformers
tf = import_transformers()
class Tok:
    pad_token_id, eos_token_id, chat_template = 0, 2, None
    def __call__(self, text):
        return {"input_ids": [3 + sum(map(ord, w)) % 60 for w in text.split()]}
    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids if i > 2)
small = dict(vocab_size=64, d_model=32, encoder_layers=1, decoder_layers=1, encoder_attention_heads=2,
             decoder_attention_heads=2, encoder_ffn_dim=64, decoder_ffn_dim=64, max_target_positions=48,
             decoder_start_token_id=1, eos_token_id=2, pad_token_id=0, bos_token_id=1, begin_suppress_tokens=None)
asr = TorchWhisperASR(model=tf.WhisperForConditionalGeneration(tf.WhisperConfig(**small)), tokenizer=Tok(),
                      max_length=8, device="cpu")
llm = TorchChatLM(model=tf.GPT2LMHeadModel(tf.GPT2Config(vocab_size=96, n_positions=128, n_embd=32, n_layer=1,
                                                         n_head=2, bos_token_id=1, eos_token_id=2, pad_token_id=0)),
                  tokenizer=Tok(), temperature=0.8, max_new_tokens=4, prompt_buckets=(16, 32), device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    class Recorder:
        def record(self, path):
            wavfile.write(path, 22050, (np.sin(np.arange(11025) / 20) * 8000).astype(np.int16))
            return True
    said = []
    asr_transcribe = asr.transcribe
    asr.transcribe = lambda path: said.append(asr_transcribe(path)) or ("hello robot" if len(said) == 1 else "end session")
    sink = ad.FileSink(tmp)
    app = FeelMe(pipe, asr=asr, llm=llm, sink=sink, recorder=Recorder(), record_path=tmp + "/in.wav", steps=2,
                 language=None)
    import builtins
    builtins.input = lambda *a: ""
    app.run()
    assert len(said) == 2 and sink.count >= 1 and len(app.history) == 2, (said, sink.count, app.history)
    Path(tmp, "story.txt").write_text("Once upon a time.\nThe end.\n")
    demos.run_story(pipe, tmp + "/story.txt", tmp, play=False, steps=2)
    relay = pepper.LocalTransport(tmp + "/relayed")
    assert pepper.run_storytelling(relay, tmp, tmp + "/story.txt", timeout=5) == 2
    Path(tmp, "scripts").mkdir()
    Path(tmp, "scripts", "script-neutral.txt").write_text("first\n")
    Path(tmp, "rec", "neutral").mkdir(parents=True)
    wavfile.write(tmp + "/rec/neutral/s-neutral-0.wav", 44100, np.zeros(4410, np.int16))
    record_audio.resample_tree(Path(tmp, "rec"))
    assert len(record_audio.make_filelist(Path(tmp, "rec"), Path(tmp, "scripts"), {"neutral": 0},
                                          Path(tmp, "list.txt"))) == 1
assert not foreign(), foreign()

from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset
from emojivoice_tpu_torch.training.train import main
with tempfile.TemporaryDirectory() as tmp:
    train, val, _ = make_alignable_dataset(Path(tmp), [0, 1], n_utts=2, seed=0)
    assert main(["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
                 "--out_dir", tmp + "/run", "--batch_size", "2", "--fast_dev_run"]) == 0
    # the loggers, a validation render, and a sweep of the trainer in process
    assert main(["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
                 "--out_dir", tmp + "/logged", "--batch_size", "2", "--max_steps", "1", "--val_every_steps", "1",
                 "--ckpt_every_steps", "0", "--render_val_samples", "1", "--loggers", "tensorboard,csv,wandb"]) == 0
    assert (Path(tmp) / "logged" / "tb" / "metrics.csv").exists()
    from emojivoice_tpu_torch.training import sweep
    assert sweep.main(["--out_dir", tmp + "/sweep", "--grid", "--space", "lr=choice:1e-4", "--", "--preset", "tiny",
                       "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
                       "--batch_size", "2", "--max_steps", "1", "--val_every_steps", "1", "--ckpt_every_steps", "0",
                       "--render_val_samples", "0"]) == 0
from emojivoice_tpu_torch.training.scratch_proof import run_scratch_proof
with tempfile.TemporaryDirectory() as tmp:
    run_scratch_proof("tiny", tmp, steps=2, batch_size=2, probe_every=1, utts=2, n_speakers=2, log_every=1,
                      assert_emergence=False, assert_free_synth=False, device="cpu")
assert not foreign(), foreign()

# the vocoder's training side and the tools around it: every console script's main, once, at a tiny size
import tomllib
scripts = tomllib.load(open("pyproject.toml", "rb"))["project"]["scripts"]
ported = {k: v for k, v in scripts.items() if v.startswith("emojivoice_tpu_torch.")}
for want in ("emojivoice-get-durations-torch", "emojivoice-data-stats-torch", "emojivoice-export-torch-torch",
             "emojivoice-train-proof-torch", "emojivoice-vocoder-proof-torch", "emojivoice-export-bundle-torch",
             "emojivoice-run-exported-torch", "emojivoice-scratch-proof-torch", "emojivoice-sweep-torch",
             "emojivoice-feel-me-torch", "emojivoice-record-audio-torch"):
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
                                        filelist=str(train), gen_mels_dir=tmp + "/durs/gen_mels", device="cpu",
                                        graphs=True)  # the captured step's staging (training/vocoder_graphs.py)
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
             "emojivoice_tpu_torch.inference.streaming", "emojivoice_tpu_torch.inference", "emojivoice_tpu_torch.apps",
             "emojivoice_tpu_torch.inference.export"):
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


def test_port_imports_neither_bench_nor_tools():
    """The JAX repo's measurement scripts (``bench.py``, ``tools/``) import JAX:
    the port's tools keep their own copies of what they need from them."""
    import ast

    files = sorted((REPO / "emojivoice_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = [a.name for a in node.names] if isinstance(node, ast.Import) else \
                [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else []
            for name in names:
                assert name.split(".")[0] not in ("bench", "tools", "bench_util"), f"{path.relative_to(REPO)}: {name}"


def _assigned(path: Path, name: str):
    """The first literal value assigned to `name` anywhere in the file."""
    import ast

    for n in ast.walk(ast.parse(path.read_text())):
        if isinstance(n, ast.Assign) and any(isinstance(t, ast.Name) and t.id == name for t in n.targets):
            try:
                return ast.literal_eval(n.value)
            except ValueError:
                continue
    raise KeyError(f"{path.name}: no literal {name}")


# the host-side pieces the port's tools copied from the JAX repo's measurement scripts, held equal to them
BENCH_COPIES = [("serving.py", "TEXTS", "tools/bench_serving.py", "TEXTS"),
                ("ttfa.py", "TEXTS", "tools/bench_ttfa.py", "TEXTS"),
                ("multilingual.py", "TEXTS", "tools/multilingual_proof.py", "TEXTS"),
                ("synthesis.py", "TEXT11", "bench.py", "text11"), ("util.py", "HEADLINE", "bench.py", "text")]
BENCH_FUNCTIONS = [("util.py", "time_median", "tools/bench_util.py"), ("serving.py", "_pct", "tools/bench_serving.py")]


@pytest.mark.parametrize("ours,name,theirs,their_name", BENCH_COPIES, ids=[c[2] for c in BENCH_COPIES])
def test_bench_copies_equal_the_jax_repos(ours, name, theirs, their_name):
    assert _assigned(REPO / "emojivoice_tpu_torch" / "bench" / ours, name) == _assigned(REPO / theirs, their_name)


@pytest.mark.parametrize("ours,name,theirs", BENCH_FUNCTIONS, ids=[f[1] for f in BENCH_FUNCTIONS])
def test_bench_functions_equal_the_jax_repos(ours, name, theirs):
    assert _function(REPO / "emojivoice_tpu_torch" / "bench" / ours, "emojivoice_tpu_torch", name) == \
        _function(REPO / theirs, "emojivoice_tpu", name)


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


# the apps' host-side copies: every top-level statement equal to the JAX package's once the package name is
# normalised and the port's spans are taken out, but for the names that differ on purpose (the ASR fallback, the
# parsers and their prog names)
APP_COPIES = {"adapters": {"WhisperASR", "TransformersLLM", "on_disk", "default_asr"}, "feel_me": {"build_parser", "main"},
              "demos": {"main"}, "game_ui": set(), "pepper": {"main"}, "record_audio": {"main"}}


def _without_spans(tree):
    """`tree` with the recorder's spans (``utils/observability.py``) taken out: a ``with obs.span(...)`` block
    is its body, ``obs.spanned(items, ...)`` is ``items``, and the recorder's import goes."""
    import ast

    class Strip(ast.NodeTransformer):
        def visit_With(self, node):
            self.generic_visit(node)
            spans = [i for i in node.items if ast.unparse(i.context_expr).startswith("obs.span(")]
            return node.body if spans and len(spans) == len(node.items) else node

        def visit_Call(self, node):
            self.generic_visit(node)
            return node.args[0] if ast.unparse(node.func) == "obs.spanned" else node

        def visit_ImportFrom(self, node):
            return None if [a.asname for a in node.names] == ["obs"] else node

    return ast.fix_missing_locations(Strip().visit(tree))


def _statements(path: Path, package: str) -> dict:
    import ast

    tree = _without_spans(ast.parse(path.read_text().replace(package, "emojivoice_tpu")))
    body = tree.body[1:]  # after the docstring
    out = {}
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            key = node.name
        elif isinstance(node, ast.Assign):
            key = ast.unparse(node.targets[0])
        else:
            key = ast.unparse(node)
        out[key] = ast.unparse(node)
    return out


@pytest.mark.parametrize("name", sorted(APP_COPIES))
def test_app_copies_equal_the_jax_packages(name):
    ours = _statements(REPO / "emojivoice_tpu_torch" / "apps" / f"{name}.py", "emojivoice_tpu_torch")
    theirs = _statements(REPO / "emojivoice_tpu" / "apps" / f"{name}.py", "emojivoice_tpu")
    differ = APP_COPIES[name]
    assert differ <= set(ours)
    assert {k: v for k, v in ours.items() if k not in differ} == {k: v for k, v in theirs.items() if k not in differ}


# the parallel slice's host-side copies: each function's AST equal to the JAX package's once the package name is
# normalised (the process-shard batching and the batch padding run on the host, identically in both)
PARALLEL_COPIES = [("parallel/mesh.py", "pad_batch_to_multiple"),
                   ("data/dataset.py", "TextMelDataset._encode_text"), ("data/dataset.py", "TextMelDataset.item_lengths"),
                   ("data/dataset.py", "BucketBatcher.__init__"), ("data/dataset.py", "BucketBatcher.__iter__"),
                   ("data/dataset.py", "BucketBatcher._collate_process_shard"),
                   ("data/dataset.py", "BucketBatcher.collate")]


def _function(path: Path, package: str, qualname: str) -> str:
    import ast

    node = ast.parse(path.read_text().replace(package, "emojivoice_tpu"))
    for part in qualname.split("."):
        node = next(n for n in node.body if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and n.name == part)
    return ast.unparse(node)


@pytest.mark.parametrize("path,qualname", PARALLEL_COPIES, ids=[q for _, q in PARALLEL_COPIES])
def test_parallel_copies_equal_the_jax_packages(path, qualname):
    assert _function(REPO / "emojivoice_tpu_torch" / path, "emojivoice_tpu_torch", qualname) == \
        _function(REPO / "emojivoice_tpu" / path, "emojivoice_tpu", qualname)
