"""The port's sweep (``training/sweep.py``) against the JAX package's: the
same space specs give the same specs and the same trials for a seed, the
objective is read as the JAX sweep reads it and ranked the same way, and each
record says which tag its objective came from.  The port's trainer runs in
process on the CPU, a failing trial included."""

import json
from pathlib import Path

import pytest
import torch

from emojivoice_tpu.training import sweep as jax_sweep
from emojivoice_tpu_torch.training import sweep
from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset

torch.set_num_threads(2)

SPECS = ["scheduler=choice:constant,cosine", "lr=log:1e-5:1e-3", "out_size=int:172:344", "warmup_steps=lin:0:50",
         "a=choice:1,2,3"]


@pytest.mark.parametrize("spec", SPECS + ["nokind", "lr=log:0:1", "x=weird:1:2", "lr=lin:2:1", "c=choice:",
                                          "lr=log:1e-5"])
def test_parse_space_equals_the_jax_sweeps(spec):
    try:
        want = jax_sweep.parse_space(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            sweep.parse_space(spec)
        assert str(got.value) == str(e)
        return
    got = sweep.parse_space(spec)
    assert (got.name, got.kind, got.choices, got.lo, got.hi) == (want.name, want.kind, want.choices, want.lo,
                                                                 want.hi)


@pytest.mark.parametrize("grid,trials,seed", [(True, 0, 0), (False, 16, 7), (False, 5, 1234)],
                         ids=["grid", "random_seed7", "random_seed1234"])
def test_build_trials_equals_the_jax_sweeps(grid, trials, seed):
    specs = [s for s in SPECS if ":choice" in s or "choice" in s] if grid else SPECS
    ours = sweep.build_trials([sweep.parse_space(s) for s in specs], grid=grid, trials=trials, seed=seed)
    theirs = jax_sweep.build_trials([jax_sweep.parse_space(s) for s in specs], grid=grid, trials=trials, seed=seed)
    assert ours == theirs and len(ours) == (6 if grid else trials)
    with pytest.raises(ValueError, match="--grid needs choice spaces only"):
        sweep.build_trials([sweep.parse_space("lr=log:1e-5:1e-3")], grid=True, trials=0, seed=0)


def test_read_objective_as_the_jax_sweep_and_says_where_it_came_from(tmp_path):
    run = tmp_path / "run"
    run.mkdir()
    rows = [{"tag": "train", "step": 1, "loss": 5.0}, {"tag": "val", "step": 2, "loss": 3.0},
            {"tag": "train", "step": 3, "loss": 4.0}, {"tag": "val", "step": 4, "loss": 2.5}]
    (run / "metrics.jsonl").write_text("\n".join(json.dumps(r) for r in rows))
    for objective in ("val/loss", "test/loss", "val", "train/loss", "val/nokey"):
        assert sweep.read_objective(run, objective) == jax_sweep.read_objective(run, objective), objective
    assert sweep.read_objective_with_source(run, "val/loss") == (2.5, "val")
    assert sweep.read_objective_with_source(run, "test/loss") == (4.0, "train")  # the silent fallback, said
    assert sweep.read_objective_with_source(tmp_path / "nope", "val/loss") == (None, None)


def test_run_sweep_ranks_as_jax_and_records_the_objectives_tag(tmp_path):
    def fake_train(argv):
        out = Path(argv[argv.index("--out_dir") + 1])
        lr = float(argv[argv.index("--lr") + 1])
        if lr > 1e-2:
            raise RuntimeError("diverged")
        out.mkdir(parents=True, exist_ok=True)
        tag = "train" if lr == 1e-3 else "val"  # one trial whose validation never ran
        (out / "metrics.jsonl").write_text(json.dumps({"tag": tag, "step": 1, "loss": lr * 100}) + "\n")
        return 0

    trials = [{"lr": 1e-4}, {"lr": 0.5}, {"lr": 1e-3}]
    ours = sweep.run_sweep(trials, tmp_path / "port", ["--ignored"], train_main=fake_train)
    theirs = jax_sweep.run_sweep(trials, tmp_path / "jax", ["--ignored"], train_main=fake_train)
    assert [r["trial"] for r in ours["ranking"]] == [r["trial"] for r in theirs["ranking"]] == [0, 2]
    assert {k: v for k, v in ours.items() if k not in ("ranking", "best")} == \
        {k: v for k, v in theirs.items() if k not in ("ranking", "best")}
    assert [r["objective_from"] for r in ours["ranking"]] == ["val", "train"]
    recs = [json.loads(line) for line in (tmp_path / "port" / "trials.jsonl").read_text().splitlines()]
    assert [r["objective_from"] for r in recs] == ["val", None, "train"]
    assert recs[1]["status"].startswith("error: RuntimeError")
    assert (tmp_path / "port" / "trial_001" / "sweep_error.log").exists()


def test_sweep_main_runs_the_ports_trainer_in_process(tmp_path):
    """Three trials of the tiny preset on the CPU through ``main``: the
    third's ``--out_size 31`` (no multiple of 4) fails inside the U-Net after
    its model is built, is recorded, and the sweep goes on."""
    train, val, _ = make_alignable_dataset(tmp_path / "corpus", [0, 1], n_utts=4, seed=0)
    out = tmp_path / "sweep"
    rc = sweep.main(["--out_dir", str(out), "--grid", "--space", "out_size=choice:64,128,31", "--",
                     "--preset", "tiny", "--device", "cpu", "--train_filelist", str(train),
                     "--valid_filelist", str(val), "--batch_size", "2", "--max_steps", "2", "--val_every_steps", "2",
                     "--ckpt_every_steps", "0", "--log_every", "1", "--render_val_samples", "0"])
    assert rc == 0
    summary = json.loads((out / "summary.json").read_text())
    assert summary["n_trials"] == 3 and summary["n_failed"] == 1
    objectives = [r["objective"] for r in summary["ranking"]]
    assert sorted(r["trial"] for r in summary["ranking"]) == [0, 1] and objectives == sorted(objectives)
    assert all(r["objective_from"] == "val" for r in summary["ranking"])
    recs = [json.loads(line) for line in (out / "trials.jsonl").read_text().splitlines()]
    assert recs[2]["status"].startswith("error: RuntimeError") and recs[2]["objective"] is None
    assert (out / "trial_002" / "exception.log").exists()  # the trainer's own record of the failure
    assert [r["params"]["out_size"] for r in recs] == ["64", "128", "31"]


def test_default_trainer_is_the_ports(monkeypatch, tmp_path):
    import emojivoice_tpu_torch.training.train as port_train

    seen = []
    monkeypatch.setattr(port_train, "main", lambda argv: seen.append(argv) or 0)
    sweep.run_sweep([{"lr": 1e-4}], tmp_path, ["--preset", "tiny"])
    assert seen and seen[0][:2] == ["--preset", "tiny"] and "--lr" in seen[0]
