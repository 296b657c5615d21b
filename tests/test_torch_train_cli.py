"""The port's training CLI on the CPU: tiny preset, the synthetic alignable
wav corpus (mirrors ``tests/test_train_cli.py``).

Checkpoint-and-resume must reproduce an unbroken run exactly: data order,
CFM draws, crop offsets and dropout are all functions of (seed, step), so the
comparison is for equality, not within a tolerance.
"""

import json

import numpy as np
import pytest
import torch

from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
from emojivoice_tpu_torch.training.state import batch_to_device, create_train_state, eval_step, train_step
from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset
from emojivoice_tpu_torch.training.train import main

torch.set_num_threads(2)

LOSS_KEYS = ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm", "lr")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("corpus")
    train, val, _ = make_alignable_dataset(root, speakers=[0, 1, 2, 3], n_utts=6, seed=0)
    return train, val


def _args(corpus, out, *extra, device="cpu"):
    train, val = corpus
    return ["--preset", "tiny", "--device", device, "--train_filelist", str(train), "--valid_filelist", str(val),
            "--out_dir", str(out), "--batch_size", "2", "--log_every", "1", *extra]


def _records(out, tag):
    return [r for r in map(json.loads, (out / "metrics.jsonl").read_text().splitlines()) if r["tag"] == tag]


def test_fast_dev_run(corpus, tmp_path):
    out = tmp_path / "fdr"
    assert main(_args(corpus, out, "--fast_dev_run")) == 0
    train, val = _records(out, "train"), _records(out, "val")
    assert [r["step"] for r in train] == [1] and [r["step"] for r in val] == [1]
    assert all(np.isfinite(train[0][k]) for k in LOSS_KEYS) and train[0]["grad_norm"] > 0
    assert CheckpointManager(str(out / "ckpts")).all_steps() == []  # a smoke run writes no checkpoint


def test_end_to_end_with_probe_test_pass_and_crop(corpus, tmp_path):
    out = tmp_path / "run"
    _, val = corpus
    assert main(_args(corpus, out, "--max_steps", "4", "--val_every_steps", "2", "--ckpt_every_steps", "2",
                      "--probe_every", "2", "--test_filelist", str(val), "--out_size", "64",
                      "--scheduler", "cosine", "--warmup_steps", "2", "--decay_steps", "10",
                      "--detect_anomaly")) == 0
    train = _records(out, "train")
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r[k]) for r in train for k in LOSS_KEYS)
    assert [r["lr"] for r in train[:3]] == pytest.approx([0.0, 5e-5, 1e-4])  # linear warm-up, then the cosine
    assert [r["step"] for r in _records(out, "val")] == [2, 4]
    test = _records(out, "test")
    assert len(test) == 1 and test[0]["step"] == 4 and np.isfinite(test[0]["loss"])
    probes = _records(out, "probe")
    assert [r["step"] for r in probes] == [0, 2, 4]
    for key in ("diagonality", "dur_mse_log", "dur_mae_frames", "prior_mel_l1", "tf_mel_l1", "mas_dur_row0"):
        assert key in probes[0]
    assert probes[0]["mas_drift_l1"] is None and probes[1]["mas_drift_l1"] is not None
    assert _records(out, "shapes")[0]["distinct_shapes"] >= 1
    mgr = CheckpointManager(str(out / "ckpts"))
    assert mgr.all_steps() == [2, 4] and mgr.load_config().model.out_size == 64
    assert json.loads((out / "ckpts" / "data_state_4.json").read_text())["batch_size"] == 2


def test_resume_repeats_an_unbroken_run_exactly(corpus, tmp_path):
    whole, broken = tmp_path / "whole", tmp_path / "broken"
    assert main(_args(corpus, whole, "--max_steps", "6", "--ckpt_every_steps", "0", "--val_every_steps", "0")) == 0
    assert main(_args(corpus, broken, "--max_steps", "3", "--ckpt_every_steps", "3", "--val_every_steps", "0")) == 0
    assert main(_args(corpus, broken, "--max_steps", "6", "--ckpt_every_steps", "3", "--val_every_steps", "0",
                      "--resume")) == 0
    a = CheckpointManager(str(whole / "ckpts")).restore(6)
    b = CheckpointManager(str(broken / "ckpts")).restore(6)
    assert a["step"] == b["step"] == 6
    for name in a["model"]:
        assert torch.equal(a["model"][name], b["model"][name]), name

    def strip(r):
        return {k: r[k] for k in ("step", *LOSS_KEYS)}
    whole_train, broken_train = _records(whole, "train"), _records(broken, "train")
    assert [r["step"] for r in broken_train] == [1, 2, 3, 4, 5, 6]  # the resumed run started at 3
    assert [strip(r) for r in broken_train] == [strip(r) for r in whole_train]


def test_resume_at_max_steps_takes_no_step(corpus, tmp_path):
    out = tmp_path / "done"
    assert main(_args(corpus, out, "--max_steps", "2", "--val_every_steps", "0")) == 0
    assert main(_args(corpus, out, "--max_steps", "2", "--val_every_steps", "0", "--resume")) == 0
    assert [r["step"] for r in _records(out, "train")] == [1, 2]


def test_cuda_device_without_a_card_fails(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(_args(corpus, tmp_path / "nocard", "--fast_dev_run", device="cuda"))
    assert "no CUDA device" in (tmp_path / "nocard" / "exception.log").read_text()


def test_dropout_acts_under_train_and_not_under_eval():
    root = cfglib.tiny()
    state = create_train_state(root.model, root.optimizer, seed=3, device="cpu")
    rng = np.random.default_rng(0)
    batch = batch_to_device({
        "x": rng.integers(1, 100, (2, 64)).astype(np.int32), "x_lengths": np.array([20, 33], np.int32),
        "y": rng.normal(size=(2, 128, 80)).astype(np.float32), "y_lengths": np.array([100, 128], np.int32),
        "spks": np.array([1, 2], np.int32)}, "cpu")
    model = state.model
    draws = dict(t=torch.full((2, 1, 1), 0.3), z=torch.zeros((2, 128, 80)))

    def losses():
        with torch.no_grad():
            return [float(v) for v in model(batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"],
                                            batch["spks"], **draws)[:3]]
    model.eval()
    assert losses() == losses()
    assert float(eval_step(model, batch)["loss"]) == float(eval_step(model, batch)["loss"])
    model.train()
    torch.manual_seed(0)
    first = losses()
    assert first != losses()  # another dropout mask, another loss
    # the trainer seeds dropout from (seed, step): the same step repeats, the next differs
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    m0 = train_step(state, batch, seed=5)
    model.load_state_dict(saved)
    state.step = 0
    assert float(train_step(state, batch, seed=5)["loss"]) == float(m0["loss"])
    model.load_state_dict(saved)
    assert float(train_step(state, batch, seed=5)["loss"]) != float(m0["loss"])  # step 1 now


def test_from_torch_ckpt_then_resume_repeats_an_unbroken_fine_tune(corpus, tmp_path):
    """A fine-tune started from a reference-format file and resumed midway
    (the flag still on the command line) continues from its own checkpoint,
    not from the file again, and ends where an unbroken one ends."""
    from emojivoice_tpu_torch.io.export_torch import export

    root = cfglib.tiny()
    start = create_train_state(root.model, root.optimizer, seed=9, device="cpu")
    CheckpointManager(str(tmp_path / "released")).save(0, start.state_dict(), cfg=root)
    ckpt = str(export(str(tmp_path / "released"), str(tmp_path / "released.ckpt")))
    common = ("--from_torch_ckpt", ckpt, "--val_every_steps", "0")
    whole, broken = tmp_path / "whole", tmp_path / "broken"
    assert main(_args(corpus, whole, "--max_steps", "4", "--ckpt_every_steps", "0", *common)) == 0
    assert main(_args(corpus, broken, "--max_steps", "2", "--ckpt_every_steps", "2", *common)) == 0
    assert main(_args(corpus, broken, "--max_steps", "4", "--ckpt_every_steps", "2", "--resume", *common)) == 0
    a = CheckpointManager(str(whole / "ckpts")).restore(4)
    b = CheckpointManager(str(broken / "ckpts")).restore(4)
    moved = 0.0
    for name, value in a["model"].items():
        assert torch.equal(value, b["model"][name]), name
        moved = max(moved, float((value - start.model.state_dict()[name]).abs().max()))
    assert moved > 1e-5  # the fine-tune left the file's weights
    assert [r["loss"] for r in _records(broken, "train")] == [r["loss"] for r in _records(whole, "train")]
    # a run without the flag starts elsewhere: the file's weights did arrive
    assert main(_args(corpus, tmp_path / "scratch", "--max_steps", "1", "--val_every_steps", "0", "--seed", "1234")) == 0
    assert _records(tmp_path / "scratch", "train")[0]["loss"] != _records(whole, "train")[0]["loss"]
