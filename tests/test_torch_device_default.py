"""The port's entry points run on the card unless the caller asks for the CPU:
without a CUDA device they raise and name ``device="cpu"``; they never carry
on on the CPU by themselves."""

import pytest
import torch

from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from emojivoice_tpu_torch.training.state import create_train_state
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

VOC = cfglib.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
                           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))


def _root():
    return cfglib.RootConfig(model=cfglib.tiny().model, vocoder=VOC)


def _state_dicts(root):
    return MatchaTTS(root.model).state_dict(), HiFiGANGenerator(root.vocoder).state_dict()


def _from_random(**kw):
    return SynthesisPipeline.from_random(_root(), seed=0, **kw)


def _from_state_dicts(**kw):
    root = _root()
    matcha_sd, hifigan_sd = _state_dicts(root)
    return SynthesisPipeline.from_state_dicts(root.model, matcha_sd, root.vocoder, hifigan_sd, **kw)


def _init(**kw):
    root = _root()
    return SynthesisPipeline(root.model, MatchaTTS(root.model), root.vocoder, HiFiGANGenerator(root.vocoder), **kw)


def _train_state(**kw):
    root = cfglib.tiny()
    return create_train_state(root.model, root.optimizer, seed=0, **kw)


def _ckpt_files(tmp_path):
    """A checkpoint directory and reference-format files of the tiny model."""
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager

    root = _root()
    matcha_sd, hifigan_sd = _state_dicts(root)
    CheckpointManager(str(tmp_path / "ckpts")).save(1, {"model": matcha_sd, "step": 1}, cfg=root)
    torch.save({"state_dict": matcha_sd}, tmp_path / "voice.ckpt")
    torch.save({"generator": hifigan_sd}, tmp_path / "generator")
    return root


def _from_checkpoint(tmp_path, **kw):
    _ckpt_files(tmp_path)
    return SynthesisPipeline.from_checkpoint(str(tmp_path / "ckpts"), str(tmp_path / "generator"), **kw)


def _from_torch_checkpoints(tmp_path, **kw):
    root = _ckpt_files(tmp_path)
    return SynthesisPipeline.from_torch_checkpoints(str(tmp_path / "voice.ckpt"), str(tmp_path / "generator"),
                                                    vocoder_cfg=root.vocoder, **kw)


ENTRY_POINTS = {"from_random": _from_random, "from_state_dicts": _from_state_dicts, "__init__": _init,
                "create_train_state": _train_state}
FILE_ENTRY_POINTS = {"from_checkpoint": _from_checkpoint, "from_torch_checkpoints": _from_torch_checkpoints}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises_and_names_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    made = ENTRY_POINTS[name](device="cpu")
    assert made.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in made.model.parameters())


def test_pipeline_on_the_cpu_synthesises():
    pipe = _from_random(device="cpu", mel_buckets=(64, 128, 256), text_buckets=(64, 128))
    res = pipe.synthesise(["asked for the cpu"], spks=[1], n_timesteps=2, seed=0)[0]
    assert res.mel_length > 0 and res.wav.shape == (res.mel_length * 16,)


@pytest.mark.parametrize("name", sorted(FILE_ENTRY_POINTS))
def test_checkpoint_loader_without_a_card_raises_and_names_the_cpu(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        FILE_ENTRY_POINTS[name](tmp_path)


@pytest.mark.parametrize("name", sorted(FILE_ENTRY_POINTS))
def test_checkpoint_loader_runs_on_the_cpu_when_asked(name, tmp_path):
    made = FILE_ENTRY_POINTS[name](tmp_path, device="cpu")
    assert made.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in list(made.model.parameters()) + list(made.vocoder.parameters()))


@pytest.fixture
def tiny_preset(monkeypatch):
    """The mains build ``from_random()``'s default preset, emoji_multi at full
    width; here that name gives the tiny config."""
    monkeypatch.setattr(cfglib, "get_preset", lambda name, **kw: _root())


def _cli_main(argv, tmp_path):
    from emojivoice_tpu_torch.inference import cli

    return cli.main(["--random_init", "--text", "hi there", "--steps", "2", "--output_folder", str(tmp_path)] + argv)


def _webapp_main(argv, tmp_path):
    from emojivoice_tpu_torch.apps import webapp

    return webapp.main(["--random_init", "--port", "0"] + argv)


MAINS = {"cli.main": _cli_main, "webapp.main": _webapp_main}


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_without_a_card_raises_and_names_the_cpu(name, tmp_path, monkeypatch, tiny_preset):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        MAINS[name]([], tmp_path)


@pytest.mark.parametrize("name", sorted(MAINS))
def test_main_runs_on_the_cpu_when_asked(name, tmp_path, monkeypatch, tiny_preset):
    from emojivoice_tpu_torch.apps import webapp

    made = []
    real_init = SynthesisPipeline.__init__

    def spy(self, *a, **kw):
        real_init(self, *a, **kw)
        made.append(self)

    monkeypatch.setattr(SynthesisPipeline, "__init__", spy)
    monkeypatch.setattr(webapp.ThreadingHTTPServer, "serve_forever", lambda self: self.server_close())
    assert MAINS[name](["--cpu"], tmp_path) == 0
    assert [p.device.type for p in made] == ["cpu"]
    if name == "cli.main":
        assert len(list(tmp_path.glob("utterance_*.wav"))) == 1


def _vocoder_state(tmp_path, **kw):
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state

    return create_vocoder_state(VOC, **kw)


def _run_vocoder_proof(tmp_path, **kw):
    from emojivoice_tpu_torch.training.vocoder_proof import run_vocoder_proof

    return run_vocoder_proof(str(tmp_path / "voc"), steps=1, cfg=VOC, **kw)


def _run_proof(tmp_path, **kw):
    from emojivoice_tpu_torch.training.proof import run_proof

    return run_proof("tiny", str(tmp_path / "proof"), steps=1, **kw)


def _get_durations_main(tmp_path, **kw):
    from emojivoice_tpu_torch.training import get_durations

    return get_durations.main(["--checkpoint_path", str(tmp_path / "none.ckpt"), "--filelist", str(tmp_path / "none.txt"),
                               "--output_dir", str(tmp_path / "out")] + [f"--{k}={v}" for k, v in kw.items()])


def _vocoder_proof_main(tmp_path, **kw):
    from emojivoice_tpu_torch.training import vocoder_proof

    return vocoder_proof.main(["--out_dir", str(tmp_path / "voc"), "--steps", "1"] + [f"--{k}={v}" for k, v in kw.items()])


VOCODER_SIDE = {"create_vocoder_state": _vocoder_state, "run_vocoder_proof": _run_vocoder_proof, "run_proof": _run_proof,
                "get_durations.main": _get_durations_main, "vocoder_proof.main": _vocoder_proof_main}


@pytest.mark.parametrize("name", sorted(VOCODER_SIDE))
def test_vocoder_side_entry_point_without_a_card_raises_and_names_the_cpu(name, tmp_path, monkeypatch):
    """The vocoder's training side and its tools: nothing is read or written
    before the missing card is reported."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available .*cpu"):
        VOCODER_SIDE[name](tmp_path)
    assert not list(tmp_path.iterdir()) or name == "run_proof"  # run_proof makes its folder first


def _card_bundle(tmp_path):
    """A manifest as ``export_bundle`` writes it on the card (its programs are not read before the device check)."""
    import json

    from emojivoice_tpu_torch.inference import export

    (tmp_path / "manifest.json").write_text(json.dumps({"format": export.FORMAT, "device": "cuda"}))
    (tmp_path / "synth_b1_t64_m64.json").write_text(json.dumps({"device": "cuda"}))
    return tmp_path


def _loaded_bundle(tmp_path, **kw):
    from emojivoice_tpu_torch.inference.export import LoadedBundle

    return LoadedBundle(str(_card_bundle(tmp_path)), **kw)


def _bundle_pipeline(tmp_path, **kw):
    from emojivoice_tpu_torch.inference.export import BundleSynthesisPipeline

    return BundleSynthesisPipeline(str(_card_bundle(tmp_path)), **kw)


def _exported_synthesizer(tmp_path, **kw):
    from emojivoice_tpu_torch.inference.export import ExportedSynthesizer

    return ExportedSynthesizer(str(_card_bundle(tmp_path) / "synth_b1_t64_m64"), **kw)


def _export_main(tmp_path, **kw):
    from emojivoice_tpu_torch.inference import export

    return export.main_export(["--random_init", "--output_dir", str(tmp_path / "bundle")] +
                              (["--cpu"] if kw.get("device") == "cpu" else []))


def _run_main(tmp_path, **kw):
    from emojivoice_tpu_torch.inference import export

    return export.main_run(["--bundle", str(_card_bundle(tmp_path)), "--text", "hi"] +
                           (["--cpu"] if kw.get("device") == "cpu" else []))


EXPORT_SIDE = {"LoadedBundle": _loaded_bundle, "BundleSynthesisPipeline": _bundle_pipeline,
               "ExportedSynthesizer": _exported_synthesizer, "main_export": _export_main, "main_run": _run_main}


@pytest.mark.parametrize("name", sorted(EXPORT_SIDE))
def test_export_side_without_a_card_raises_and_names_the_cpu(name, tmp_path, monkeypatch, tiny_preset):
    """The export and its runners default to the card: without one they
    raise and name the CPU, and write no bundle."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"|--cpu'):
        EXPORT_SIDE[name](tmp_path)
    assert not (tmp_path / "bundle").exists()


@pytest.mark.parametrize("name", ["LoadedBundle", "BundleSynthesisPipeline", "ExportedSynthesizer", "main_run"])
def test_a_card_bundle_refuses_the_cpu(name, tmp_path):
    """A program runs on the device it was exported on: asked for the CPU,
    a bundle made on the card says to export one with --cpu."""
    with pytest.raises(ValueError, match="exported on cuda.*--cpu"):
        EXPORT_SIDE[name](tmp_path, device="cpu")


def _run_scratch_proof(tmp_path, **kw):
    from emojivoice_tpu_torch.training.scratch_proof import run_scratch_proof

    return run_scratch_proof("tiny", str(tmp_path / "scratch"), steps=1, **kw)


def _scratch_proof_main(tmp_path, **kw):
    from emojivoice_tpu_torch.training import scratch_proof

    return scratch_proof.main(["--preset", "tiny", "--out_dir", str(tmp_path / "scratch"), "--steps", "1"]
                              + [f"--{k}={v}" for k, v in kw.items()])


TRAINING_TOOLS = {"run_scratch_proof": _run_scratch_proof, "scratch_proof.main": _scratch_proof_main}


@pytest.mark.parametrize("name", sorted(TRAINING_TOOLS))
def test_training_tool_without_a_card_raises_and_names_the_cpu(name, tmp_path, monkeypatch):
    """The scratch proof runs on the card unless asked: without one it stops
    before it writes its corpus."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device is available .*cpu"):
        TRAINING_TOOLS[name](tmp_path)
    assert not list(tmp_path.iterdir())


def test_sweep_trials_run_on_the_card_unless_asked(tmp_path, monkeypatch):
    """The sweep's trials are the trainer's runs: without ``--device cpu`` among
    the shared flags each trial asks for the card, and without one each is
    recorded with the trainer's refusal (no trial carries on on the CPU)."""
    import json

    from emojivoice_tpu_torch.training import sweep

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "sweep"
    rc = sweep.main(["--out_dir", str(out), "--grid", "--space", "lr=choice:1e-4,1e-3", "--", "--preset", "tiny",
                     "--train_filelist", str(tmp_path / "none.txt"), "--valid_filelist", str(tmp_path / "none.txt")])
    assert rc == 1
    recs = [json.loads(line) for line in (out / "trials.jsonl").read_text().splitlines()]
    assert [r["status"] for r in recs] == ["error: RuntimeError: --device cuda: no CUDA device is available (pass "
                                           "--device cpu to train on the CPU)"] * 2
