"""The port's ``get_durations`` tool against the JAX package's on the CPU.

Both tools read the same reference-format ``.ckpt`` (written here by the JAX
package from a flax init of the ``tiny`` preset, as ``tests/test_torch_ckpt.py``
does) and the same filelist of the seeded synthetic corpus.  ``durations/*.npy``
must be equal (MAS paths are integers; a corpus that put the search on a near
tie would have to be replaced, not tolerated), the ``.json`` spans equal, and
the teacher-forced ``gen_mels`` at ``--temperature 0`` (no noise on either
side) within a mel-MAE of 1e-3 (two Euler steps of the f32 decoder).
"""

import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from emojivoice_tpu.config import OptimizerConfig, get_preset
from emojivoice_tpu.io.torch_ckpt import export_matcha_hparams, export_matcha_state_dict
from emojivoice_tpu.training import create_train_state
from emojivoice_tpu.training import get_durations as jax_tool
from emojivoice_tpu_torch.ops import mas
from emojivoice_tpu_torch.training import get_durations as port_tool
from emojivoice_tpu_torch.training.proof import make_dataset

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("durations")
    train_fl, _ = make_dataset(tmp / "data", tuple(range(4)), n_utts=3, seconds=1.0, seed=0)
    root = get_preset("tiny")
    state = create_train_state(root.model, OptimizerConfig(), seed=0)
    sd = export_matcha_state_dict(jax.device_get(state.params), root.model)
    ckpt = tmp / "tiny.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()},
                "hyper_parameters": export_matcha_hparams(root.model)}, ckpt)
    return tmp, train_fl, ckpt


def _args(ckpt, filelist, out, *extra):
    return ["--checkpoint_path", str(ckpt), "--filelist", str(filelist), "--preset", "tiny", "--output_dir", str(out),
            "--batch_size", "2", *extra]


def test_durations_and_gen_mels_match_the_jax_tool(setup):
    tmp, train_fl, ckpt = setup
    gen = ["--gen_mels", "--n_timesteps", "2", "--temperature", "0"]
    assert jax_tool.main(_args(ckpt, train_fl, tmp / "jax", *gen)) == 0
    before = mas.launches
    assert port_tool.main(_args(ckpt, train_fl, tmp / "port", "--device", "cpu", *gen)) == 0
    assert mas.launches == before  # on the CPU the plain search runs, and is not counted as a launch
    stems = sorted(p.stem for p in (tmp / "jax" / "durations").glob("*.npy"))
    assert stems == ["u0", "u1", "u2"] == sorted(p.stem for p in (tmp / "port" / "durations").glob("*.npy"))
    for stem in stems:
        theirs, ours = (np.load(tmp / side / "durations" / f"{stem}.npy") for side in ("jax", "port"))
        assert ours.dtype == np.float32 and ours.sum() > 0
        np.testing.assert_array_equal(ours, theirs, err_msg=stem)
        spans = [json.loads((tmp / side / "durations" / f"{stem}.json").read_text()) for side in ("jax", "port")]
        assert spans[0] == spans[1] and list(spans[0].values())[-1]["endtime"] == int(ours.sum())
        theirs, ours = (np.load(tmp / side / "gen_mels" / f"{stem}.npy") for side in ("jax", "port"))
        assert ours.dtype == np.float32 and ours.shape == theirs.shape == (int(round(ours.shape[0])), 80)
        assert ours.shape[0] == int(round(np.load(tmp / "port" / "durations" / f"{stem}.npy").sum()))
        assert float(np.abs(ours - theirs).mean()) < 1e-3, stem


def test_noise_is_keyed_by_seed_and_batch(setup):
    tmp, train_fl, ckpt = setup
    gen = ["--device", "cpu", "--gen_mels", "--n_timesteps", "1"]
    for name, seed in (("a", "3"), ("b", "3"), ("c", "4")):
        assert port_tool.main(_args(ckpt, train_fl, tmp / name, *gen, "--seed", seed)) == 0
    a, b, c = (np.load(tmp / name / "gen_mels" / "u0.npy") for name in "abc")
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3 and np.isfinite(c).all()
    # without --gen_mels no mel is written, and the durations do not depend on the noise
    assert port_tool.main(_args(ckpt, train_fl, tmp / "d", "--device", "cpu")) == 0
    assert not (tmp / "d" / "gen_mels").exists()
    np.testing.assert_array_equal(np.load(tmp / "d" / "durations" / "u1.npy"),
                                  np.load(tmp / "a" / "durations" / "u1.npy"))


def test_reads_the_trainers_checkpoint_directory(setup):
    """``--checkpoint_path`` also takes the ``ckpts/`` folder of the port's
    trainer: same weights, same durations."""
    from emojivoice_tpu_torch import config as cfglib
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.io.torch_ckpt import load_matcha

    tmp, train_fl, ckpt = setup
    sd, cfg = load_matcha(str(ckpt))
    root = cfglib.get_preset("tiny")
    assert cfglib.to_dict(cfg) == cfglib.to_dict(root.model)
    CheckpointManager(str(tmp / "ckpts")).save(7, {"model": sd, "step": 7}, cfg=root)
    assert port_tool.main(_args(tmp / "ckpts", train_fl, tmp / "from_dir", "--device", "cpu")) == 0
    assert port_tool.main(_args(ckpt, train_fl, tmp / "from_file", "--device", "cpu")) == 0
    for stem in ("u0", "u1", "u2"):
        np.testing.assert_array_equal(np.load(tmp / "from_dir" / "durations" / f"{stem}.npy"),
                                      np.load(tmp / "from_file" / "durations" / f"{stem}.npy"))


def test_duplicate_stems_and_a_missing_card_are_refused(setup):
    tmp, train_fl, ckpt = setup
    rows = train_fl.read_text().splitlines()
    other = tmp / "elsewhere" / "u0.wav"
    other.parent.mkdir()
    other.write_bytes(Path(rows[0].split("|")[0]).read_bytes())
    dup = tmp / "dup.txt"
    dup.write_text("\n".join(rows + [f"{other}|1|a second u0"]) + "\n")
    with pytest.raises(SystemExit, match="duplicate basename stem 'u0'") as ours:
        port_tool.main(_args(ckpt, dup, tmp / "dup_out", "--device", "cpu"))
    with pytest.raises(SystemExit) as theirs:
        jax_tool.main(_args(ckpt, dup, tmp / "dup_out_jax"))
    assert str(ours.value) == str(theirs.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_tool.main(_args(ckpt, train_fl, tmp / "nocard"))


@pytest.mark.parametrize("durations,phones", [([2, 5, 1, 4, 3], ["a", "b"]), ([0, 3, 0, 2, 0], ["x", "y"]),
                                              ([1, 1, 1], ["z"]), ([4, 0, 2, 7, 0, 1, 5], ["p", "q", "r"])])
def test_get_phoneme_durations_equals_the_jax_function(durations, phones):
    ours = port_tool.get_phoneme_durations(durations, phones)
    assert ours == jax_tool.get_phoneme_durations(durations, phones)
    assert list(ours.values())[-1]["endtime"] == sum(durations)
