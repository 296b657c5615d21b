"""The port's proof tools and the small tools around them on the CPU:
``training/proof.py``, ``training/vocoder_proof.py``, ``data/stats.py``,
``io/export_torch.py`` and the trainer's ``--from_torch_ckpt``.

The corpus makers and the segment sampler must equal the JAX package's to the
sample (the same ``numpy`` generator in the same draw order); the data
statistics agree to 1e-6 (float64 sums of the same f32 mels).  The two proof
runs are tiny: the vocoder fine-tune uses the narrow ×256 generator of
``tests/test_vocoder_finetune.py`` against full-width discriminators on
batch 2 × 16 frames, conditioned on mels that the port's ``get_durations``
dumped, and the harness's own assert must see the mel-L1 fall.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.data import stats as jax_stats
from emojivoice_tpu.training import proof as jax_proof
from emojivoice_tpu.training import vocoder_proof as jax_vocoder_proof
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.data import stats
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.io import export_torch, torch_ckpt
from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
from emojivoice_tpu_torch.training import get_durations, proof, vocoder_proof
from emojivoice_tpu_torch.training.state import create_train_state
from emojivoice_tpu_torch.training.train import main as train_main
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

torch.set_num_threads(2)

NARROW = cfglib.HiFiGANConfig(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=32,
                              resblock_kernel_sizes=(3,), resblock_dilation_sizes=((1, 3),), num_mels=80)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    train, val = proof.make_dataset(root / "port", tuple(range(4)), n_utts=6, seconds=2.0, seed=0)
    return root, train, val


def test_make_dataset_equals_the_jax_packages(corpus):
    root, train, val = corpus
    jtrain, jval = jax_proof.make_dataset(root / "jax", tuple(range(4)), n_utts=6, seconds=2.0, seed=0)
    assert proof.EMOJI_SPEAKERS == jax_proof.EMOJI_SPEAKERS
    for ours, theirs in ((train, jtrain), (val, jval)):
        rows, jrows = ours.read_text().splitlines(), theirs.read_text().splitlines()
        assert [r.split("|")[1:] for r in rows] == [r.split("|")[1:] for r in jrows]
        for r, jr in zip(rows, jrows):
            (sr, a), (jsr, b) = wavfile.read(r.split("|")[0]), wavfile.read(jr.split("|")[0])
            assert sr == jsr == 22050 and a.dtype == np.float32
            np.testing.assert_array_equal(a, b)


def test_segment_sampler_equals_the_jax_packages():
    rng = np.random.default_rng(1)
    pairs = [(rng.normal(size=(n, 80)).astype(np.float32), rng.normal(size=(n * 256,)).astype(np.float32))
             for n in (40, 33, 57)]
    ours = vocoder_proof.make_segment_sampler(pairs, 32, 256, 5, seed=9)
    theirs = jax_vocoder_proof.make_segment_sampler(pairs, 32, 256, 5, seed=9)
    for _ in range(3):
        a, b = ours(), theirs()
        assert a["mel"].shape == (5, 32, 80) and a["wav"].shape == (5, 32 * 256)
        np.testing.assert_array_equal(a["mel"], b["mel"])
        np.testing.assert_array_equal(a["wav"], b["wav"])
    with pytest.raises(ValueError, match="exceeds the shortest utterance"):
        vocoder_proof.make_segment_sampler(pairs, 34, 256, 5, seed=9)


def test_data_statistics_equal_the_jax_packages(corpus, tmp_path, capsys):
    _, train, _ = corpus
    ours = stats.compute_data_statistics(str(train), cfglib.get_preset("tiny").data)
    theirs = jax_stats.compute_data_statistics(str(train), jax_cfglib.get_preset("tiny").data)
    assert sorted(ours) == ["mel_mean", "mel_std"]
    np.testing.assert_allclose([ours["mel_mean"], ours["mel_std"]], [theirs["mel_mean"], theirs["mel_std"]],
                               rtol=0, atol=1e-6)
    assert stats.main(["--filelist", str(train), "--preset", "tiny", "--output", str(tmp_path / "s.json")]) == 0
    assert json.loads((tmp_path / "s.json").read_text()) == ours == json.loads(capsys.readouterr().out)


@pytest.fixture(scope="module")
def trained(corpus, tmp_path_factory):
    """A tiny acoustic model as the port's trainer stores it, exported to a
    reference-format file."""
    tmp = tmp_path_factory.mktemp("trained")
    root = cfglib.get_preset("tiny")
    state = create_train_state(root.model, root.optimizer, seed=0, device="cpu")
    CheckpointManager(str(tmp / "ckpts")).save(3, state.state_dict(), cfg=root)
    ckpt = export_torch.export(str(tmp / "ckpts"), str(tmp / "voice.ckpt"))
    return tmp, root, state, ckpt


def test_export_torch_round_trip(trained, tmp_path):
    tmp, root, state, ckpt = trained
    sd, cfg = torch_ckpt.load_matcha(str(ckpt))
    assert cfglib.to_dict(cfg) == cfglib.to_dict(root.model)
    want = state.model.state_dict()
    assert sorted(sd) == sorted(want) and all(torch.equal(sd[k], want[k]) for k in want)
    # the hyper-parameters are the block the JAX package writes for the same config
    from emojivoice_tpu.io.torch_ckpt import export_matcha_hparams

    hp = torch_ckpt.extract_hyper_parameters(torch_ckpt.load_torch_file(str(ckpt)))
    assert hp == export_matcha_hparams(jax_cfglib.get_preset("tiny").model)
    assert export_torch.main(["--ckpt_dir", str(tmp / "ckpts"), "--output", str(tmp_path / "again.ckpt"),
                              "--step", "3"]) == 0
    again = torch_ckpt.load_torch_state_dict(str(tmp_path / "again.ckpt"))
    assert all(torch.equal(again[k], want[k]) for k in want)
    pipe = SynthesisPipeline.from_torch_checkpoints(str(ckpt), vocoder_cfg=NARROW, device="cpu",
                                                    cleaners=("basic_cleaners",), mel_buckets=(64, 128, 256),
                                                    text_buckets=(64,))
    assert pipe.synthesise(["exported"], spks=[1], n_timesteps=2, seed=0)[0].mel_length > 0


def test_from_torch_ckpt_starts_from_the_files_weights(trained, corpus, tmp_path):
    _, root, state, ckpt = trained
    _, train, val = corpus
    args = ["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
            "--batch_size", "2", "--val_every_steps", "0", "--log_every", "1", "--lr", "0", "--max_steps", "1"]
    assert train_main(args + ["--out_dir", str(tmp_path / "ft"), "--from_torch_ckpt", str(ckpt)]) == 0
    after = CheckpointManager(str(tmp_path / "ft" / "ckpts")).restore(1)["model"]
    want = state.model.state_dict()
    assert all(torch.equal(after[k], want[k]) for k in want)  # lr 0: the step moved nothing, the load was whole
    # a checkpoint that does not fit the preset's data is refused by the field's name
    sd, cfg = torch_ckpt.load_matcha(str(ckpt))
    odd = dataclasses.replace(cfg, n_spks=7)
    sd = dict(sd, **{"spk_emb.weight": torch.zeros(7, cfg.spk_emb_dim)})
    torch.save({"state_dict": sd, "hyper_parameters": torch_ckpt.matcha_hyper_parameters(odd)}, tmp_path / "odd.ckpt")
    with pytest.raises(ValueError, match="n_spks=7"):
        train_main(args + ["--out_dir", str(tmp_path / "odd"), "--from_torch_ckpt", str(tmp_path / "odd.ckpt")])


def test_run_vocoder_proof_on_generated_mels(trained, corpus, tmp_path):
    """get_durations --gen_mels → run_vocoder_proof --gen_mels_dir → the
    trained generator's dump, folded and served."""
    tmp, _, _, _ = trained
    _, train, _ = corpus
    assert get_durations.main(["--checkpoint_path", str(tmp / "ckpts"), "--filelist", str(train), "--preset", "tiny",
                               "--output_dir", str(tmp_path / "durs"), "--batch_size", "3", "--device", "cpu",
                               "--gen_mels", "--n_timesteps", "2"]) == 0
    for row in train.read_text().splitlines():
        stem = row.split("|")[0].rsplit("/", 1)[-1].rsplit(".", 1)[0]
        gm = np.load(tmp_path / "durs" / "gen_mels" / f"{stem}.npy")
        assert gm.shape == (int(round(np.load(tmp_path / "durs" / "durations" / f"{stem}.npy").sum())), 80)
    out = tmp_path / "voc"
    s = vocoder_proof.run_vocoder_proof(str(out), steps=8, batch_size=2, segment_frames=16, window=3, cfg=NARROW,
                                        log_every=2, filelist=str(train),
                                        gen_mels_dir=str(tmp_path / "durs" / "gen_mels"), device="cpu")
    # the harness itself asserts the mel-L1 drop and finite losses
    assert s["fine_tuning"] is True and s["data"] == "filelist" and s["backend"] == "cpu" and s["weight_norm"]
    assert s["mel_l1_last_mean"] < s["mel_l1_first_mean"] and s["segment_samples"] == 16 * 256
    records = [json.loads(line) for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in records] == [2, 4, 6, 8]
    assert json.loads((out / "summary.json").read_text()) == s
    for name in ("before.wav", "after.wav"):
        sr, wav = wavfile.read(out / name)
        assert sr == 22050 and np.isfinite(wav).all() and len(wav) % 256 == 0
    # the dump keeps the weight norm; folded it loads into a plain generator, kept it goes on training
    folded = torch_ckpt.load_hifigan(str(out / s["generator_ckpt"]))
    HiFiGANGenerator(NARROW).load_state_dict(folded, strict=True)
    kept = torch_ckpt.load_hifigan(str(out / s["generator_ckpt"]), fold=False)
    HiFiGANGenerator(NARROW, weight_norm=True).load_state_dict(kept, strict=True)
    # a second run warm-starts from that dump and from a do_* file of discriminators (plain weights here)
    from emojivoice_tpu_torch.vocoder.discriminators import MultiPeriodDiscriminator, MultiScaleDiscriminator

    torch.manual_seed(0)
    torch.save({"mpd": MultiPeriodDiscriminator().state_dict(), "msd": MultiScaleDiscriminator().state_dict(),
                "steps": 8}, tmp_path / "do_00000008")
    s2 = vocoder_proof.run_vocoder_proof(str(tmp_path / "voc2"), steps=6, batch_size=2, segment_frames=16, window=3,
                                         cfg=NARROW, filelist=str(train), gen_ckpt=str(out / s["generator_ckpt"]),
                                         disc_ckpt=str(tmp_path / "do_00000008"), device="cpu")
    assert s2["fine_tuning"] is False and s2["steps"] == 6
    assert s2["mel_l1_first_mean"] < s["mel_l1_first_mean"]  # it started from the trained generator, not from scratch


def test_generated_mels_are_checked(corpus, tmp_path):
    """A channels-first mel folder, and one with far too few frames, fail
    loudly instead of conditioning on misaligned mels; so does a missing card."""
    _, train, _ = corpus
    stems = [row.split("|")[0].rsplit("/", 1)[-1].rsplit(".", 1)[0] for row in train.read_text().splitlines()]
    for name, shape, match in (("cf", (80, 172), "channels-last"), ("short", (100, 80), "frames vs")):
        (tmp_path / name).mkdir()
        for stem in stems:
            np.save(tmp_path / name / f"{stem}.npy", np.zeros(shape, np.float32))
        with pytest.raises(ValueError, match=match):
            vocoder_proof.run_vocoder_proof(str(tmp_path / "voc"), steps=1, batch_size=1, segment_frames=4, cfg=NARROW,
                                            filelist=str(train), gen_mels_dir=str(tmp_path / name), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            vocoder_proof.run_vocoder_proof(str(tmp_path / "voc"), steps=1, cfg=NARROW)


def test_run_proof_tiny(tmp_path, monkeypatch):
    """Surrogate checkpoint → ``--from_torch_ckpt`` → 16 steps → the loss
    window falls → the run's checkpoint is served.  The served vocoder is made
    narrow to keep the CPU's work small."""
    real = SynthesisPipeline.from_checkpoint.__func__

    def narrow_from_checkpoint(cls, ckpt_dir, *a, **kw):
        mgr = CheckpointManager(ckpt_dir)
        mgr.save(mgr.latest_step(), mgr.restore(), cfg=dataclasses.replace(mgr.load_config(), vocoder=NARROW))
        return real(cls, ckpt_dir, *a, mel_buckets=(64, 128, 256, 512, 1024), **kw)
    monkeypatch.setattr(SynthesisPipeline, "from_checkpoint", classmethod(narrow_from_checkpoint))
    s = proof.run_proof("tiny", str(tmp_path / "proof"), steps=16, batch_size=4, out_size=100, utts=8, log_every=2,
                        device="cpu")
    assert s["loss_drop"] > 0 and s["steps"] == 16 and s["backend"] == "cpu" and s["audio_seconds"] > 0
    assert (tmp_path / "proof" / "proof.wav").exists() and (tmp_path / "proof" / "surrogate.ckpt").exists()
    assert json.loads((tmp_path / "proof" / "summary.json").read_text()) == s
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            proof.run_proof("tiny", str(tmp_path / "nocard"), steps=1)
