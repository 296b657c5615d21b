"""The port's parallelism (``emojivoice_tpu_torch/parallel/`` and its hooks)
against the JAX package, on the CPU over gloo at the ``tiny`` width.

In process: the placement rules against JAX's ``spec_for`` leaf by leaf (each
torch name found by carrying index-tagged JAX leaves through
``io/from_jax.py``), ``count_sharded``, tp 1, and the host-side copies
(``pad_batch_to_multiple``, the batcher's process-shard collation) against
the JAX functions.

One spawned two-rank gloo group (``tests/torch_parallel_worker.py``) runs a
DDP step and a TP-2 step, each held to the JAX one-device step on the same
batch with the port's ``(seed, step)`` draws injected and dropout off
(losses rtol 1e-4, ``tests/test_torch_training.py``'s bound; parameters
after one Adam step atol 1e-4, that file's lr per step), TP-2 synthesis
against the whole model (mel atol 1e-4, ``tests/test_tp.py:121``) and the
TP-2 vocoder (to the bit: K1's twin runs on the gathered weights), the DP-2
pipeline against the meshless one (wav atol 1e-4, ``tests/test_tp.py:148``),
and the DCP round trip (to the bit).

``slow``, as the JAX package marks ``tests/test_tp.py`` and
``tests/test_dcn.py``: the trainer CLI over two ranks (``--num_devices`` and
``--dcn_*``), tp 4 with a cut head, the conformer's BatchNorm under DDP and
the vocoder step's ``mesh=``.
"""

import functools
import json
import os
import socket
import subprocess
import sys
import textwrap
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.parallel import mesh as jax_mesh
from emojivoice_tpu.parallel import tp as jax_tp
from emojivoice_tpu.training import state as jax_state
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax
from emojivoice_tpu_torch.parallel import mesh as port_mesh
from emojivoice_tpu_torch.parallel import tp as port_tp
from emojivoice_tpu_torch.utils.prng import training_draws
from tests import torch_parallel_worker as worker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = worker.no_dropout_cfg(cfglib.get_preset("tiny").model)
JCFG = jax_cfglib.get_preset("tiny").model
B, TX, TY, SEED = 4, 16, 32, 5


def _tagged(tree):
    """Every leaf filled with its own index (exact in f32), the paths beside."""
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    paths = ["/".join(jax_tp._key_name(k) for k in path) for path, _ in leaves]
    filled = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree),
                                          [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(leaves)])
    return filled, paths, [leaf.shape for _, leaf in leaves]


def _torch_dim(jax_spec, ndim: int):
    """JAX's split dim in the flax layout → the port's, in torch's: -1 → 0, -2 → 1."""
    dims = [d for d, axis in enumerate(jax_spec) if axis == jax_tp.MODEL_AXIS]
    return None if not dims else {-1: 0, -2: 1}[dims[0] - ndim]


@functools.lru_cache(maxsize=None)
def _trees():
    """(name, JAX params shaped tree, port state-dict function) of the acoustic model and a narrow HiFi-GAN."""
    model = FlaxMatcha(cfg=JCFG)
    matcha = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0)}, jnp.ones((1, 8), jnp.int32), jnp.array([8]), 16, 1, 1.0, jnp.array([0]),
        1.0, None, jnp.zeros((1, 16, JCFG.n_feats)), method=FlaxMatcha.synthesise))
    voc_cfg = jax_cfglib.HiFiGANConfig(upsample_initial_channel=64)
    voc = jax.eval_shape(lambda: FlaxHiFiGAN(cfg=voc_cfg).init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 80))))
    port_voc = cfglib.HiFiGANConfig(upsample_initial_channel=64)
    return [("matcha", matcha, lambda t: matcha_state_dict_from_flax(t, cfglib.get_preset("tiny").model,
                                                                      buffers=False)),
            ("hifigan", voc, lambda t: hifigan_state_dict_from_flax(t, port_voc))]


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_rules_place_every_leaf_as_jax_does(tp):
    """For every JAX parameter leaf, the port's table splits the torch entry
    it becomes on the dimension JAX's ``spec_for`` names, after the layout
    change, or replicates it as JAX does."""
    splits = 0
    for name, tree, to_torch in _trees():
        tagged, paths, shapes = _tagged(tree)
        sd = to_torch(tagged)
        assert len(sd) == len(paths), name
        for key, value in sd.items():
            i = int(value.reshape(-1)[0])
            assert (value == i).all(), key
            want = _torch_dim(jax_tp.spec_for(paths[i], shapes[i], tp), len(shapes[i]))
            got = port_tp.spec_for(key, value.shape, tp)
            assert (got.dim if isinstance(got, port_tp.Shard) else None) == want, (key, paths[i], got, want)
            splits += want is not None
    assert (splits > 0) == (tp > 1)


@pytest.mark.parametrize("tp", [1, 2, 4, 8])
def test_count_sharded_equals_jax(tp):
    mesh = types.SimpleNamespace(shape={"data": 1, "model": tp})
    for name, tree, to_torch in _trees():
        tagged, _, _ = _tagged(tree)
        assert port_tp.count_sharded(to_torch(tagged), mesh) == jax_tp.count_sharded(tree, mesh), name


def test_tp_degree_one_is_fully_replicated():
    mesh = types.SimpleNamespace(shape={"data": 8, "model": 1})
    from emojivoice_tpu_torch.models.matcha import MatchaTTS

    specs = port_tp.tp_specs(MatchaTTS(CFG).state_dict(), mesh)
    assert all(s == port_tp.Replicate() for s in specs.values())
    assert all(p == (port_tp.Replicate(),) * 2 for p in port_tp.tp_shardings({"a.b": (2, 2)}, mesh).values())


@pytest.mark.parametrize("b,n", [(5, 4), (8, 4), (3, 1), (1, 2)])
def test_pad_batch_to_multiple_equals_jax(b, n):
    rng = np.random.default_rng(b * 10 + n)
    batch = {"x": rng.integers(0, 9, (b, 6)).astype(np.int32), "y": rng.normal(size=(b, 4, 3)).astype(np.float32)}
    ours, theirs = port_mesh.pad_batch_to_multiple(batch, n), jax_mesh.pad_batch_to_multiple(batch, n)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k])
        assert ours[k].dtype == theirs[k].dtype
    sl = port_mesh.rows(types.SimpleNamespace(size=lambda axis: n, rank=lambda axis: n - 1), ours["x"].shape[0])
    assert sl.stop == ours["x"].shape[0]  # the last data rank's rows end the padded batch


@pytest.fixture
def filelists(tmp_path, rng):
    """``tests/test_dcn.py``'s corpus: seven rows, an uneven final batch at bs 4."""
    from scipy.io import wavfile

    wav_dir = tmp_path / "wavs"
    wav_dir.mkdir()
    rows = []
    texts = ["hello there", "a second line", "third one here", "the final row", "five alive", "six sticks",
             "seven eleven"]
    for i, t in enumerate(texts):
        p = wav_dir / f"u{i}.wav"
        wavfile.write(p, 22050, (rng.normal(size=22050 // 4 + 511 * i) * 0.1).astype(np.float32))
        rows.append(f"{p}|{i % 4}|{t}")
    train = tmp_path / "train.txt"
    train.write_text("\n".join(rows) + "\n")
    return train


def test_process_shard_collation_equals_jax(filelists):
    """The port's batcher in process-shard mode gives the JAX batcher's
    batches on both ranks (global buckets, local rows, zero-weight pads),
    and ``item_lengths`` agrees with ``__getitem__``."""
    import dataclasses

    from emojivoice_tpu.data.dataset import BucketBatcher as JaxBatcher, TextMelDataset as JaxDataset
    from emojivoice_tpu_torch.data.dataset import BucketBatcher, TextMelDataset

    def data_cfg(module):
        return dataclasses.replace(module.get_preset("tiny").data, train_filelist_path=str(filelists),
                                   valid_filelist_path=str(filelists), batch_size=4, seed=0)

    ours_ds, theirs_ds = TextMelDataset(str(filelists), data_cfg(cfglib)), JaxDataset(str(filelists),
                                                                                      data_cfg(jax_cfglib))
    for j in range(len(ours_ds)):
        assert ours_ds.item_lengths(j) == theirs_ds.item_lengths(j) == (len(ours_ds[j]["x"]), ours_ds[j]["y"].shape[0])
    total = 0.0
    for pid in (0, 1):
        ours = list(BucketBatcher(ours_ds, 4, shuffle=True, seed=0, process_shard=(pid, 2)))
        theirs = list(JaxBatcher(theirs_ds, 4, shuffle=True, seed=0, process_shard=(pid, 2)))
        assert len(ours) == len(theirs) == 2
        for a, b in zip(ours, theirs):
            assert sorted(a) == sorted(b)
            for k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6, err_msg=k)
            total += float(a["row_mask"].sum())
    assert total == 7.0  # every row once, the pads masked out
    with pytest.raises(ValueError):
        BucketBatcher(ours_ds, 5, process_shard=(0, 2))


# ---------------------------------------------------------------------- #
# one two-rank gloo group
# ---------------------------------------------------------------------- #

def _batch():
    rng = np.random.default_rng(0)
    xl, yl = np.array([16, 11, 14, 9], np.int32), np.array([32, 27, 30, 20], np.int32)
    x = np.zeros((B, TX), np.int32)
    y = np.zeros((B, TY, CFG.n_feats), np.float32)
    for i in range(B):
        x[i, : xl[i]] = rng.integers(1, 170, xl[i])
        y[i, : yl[i]] = rng.normal(size=(yl[i], CFG.n_feats)).astype(np.float32)
    return {"x": x, "x_lengths": xl, "y": y, "y_lengths": yl, "spks": np.array([1, 3, 0, 2], np.int32)}


def _jax_step(model, params, batch):
    """The JAX one-device step on the global batch, with the port's draws."""
    draws = training_draws(SEED, 0, B, TY, CFG.n_feats, "cpu")
    jopt = jax_cfglib.OptimizerConfig()
    tx = jax_state.make_optimizer(jopt)

    @jax.jit
    def step(p, args, t, z, rows):
        def loss_fn(pp):
            dur, prior, diff, _ = model.apply(pp, *args, rng=jax.random.PRNGKey(0), deterministic=True, t=t, z=z,
                                              row_mask=rows)
            return dur + prior + diff, (dur, prior, diff)
        (total, (dur, prior, diff)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(g["params"], tx.init(p["params"]), p["params"])
        return {"params": optax.apply_updates(p["params"], updates)}, {
            "loss": total, "dur_loss": dur, "prior_loss": prior, "diff_loss": diff,
            "grad_norm": optax.global_norm(g["params"])}

    args = tuple(jnp.asarray(batch[k]) for k in ("x", "x_lengths", "y", "y_lengths", "spks"))
    new, metrics = step(params, args, jnp.asarray(draws["t"].numpy()), jnp.asarray(draws["z"].numpy()),
                        jnp.ones((B,), jnp.float32))
    return matcha_state_dict_from_flax(jax.device_get(new), CFG, buffers=False), jax.device_get(metrics)


def _weights():
    """The tiny model's weights: the port's seeded init with every parameter
    moved off its start (flax and torch start some biases and SnakeBeta's α,
    β at zero) → (the port's state dict, the JAX package's params of it)."""
    from emojivoice_tpu.io.torch_ckpt import convert_matcha_state_dict
    from emojivoice_tpu_torch.models.matcha import MatchaTTS

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = MatchaTTS(CFG)
    rng = np.random.default_rng(42)
    params = {k for k, _ in model.named_parameters()}
    sd = {k: (v.numpy() + 0.05 * rng.normal(size=v.shape) if k in params else v.numpy()).astype(np.float32)
          for k, v in model.state_dict().items()}
    return sd, convert_matcha_state_dict(sd, JCFG)


@pytest.fixture(scope="module")
def group_run():
    from concurrent.futures import ThreadPoolExecutor

    sd, params = _weights()
    batch = _batch()
    srng = np.random.default_rng(7)
    x = np.zeros((1, 16), np.int64)
    x[0, :13] = srng.integers(1, 170, 13)
    inputs = {**batch, **{f"sd.{k}": v for k, v in sd.items()},
              "synth_x": x, "synth_xl": np.array([13]),
              "synth_z": srng.normal(size=(1, 64, CFG.n_feats)).astype(np.float32),
              "voc_mel": srng.normal(size=(1, 24, 80)).astype(np.float32)}
    with ThreadPoolExecutor(1) as pool:  # the ranks run while this process computes the JAX step
        ranks = pool.submit(worker.launch, ["ddp_step", "tp_step", "dcp", "tp_synth", "dp_pipeline"], 2, inputs,
                            SEED)
        theirs = _jax_step(FlaxMatcha(cfg=JCFG), params, batch)
        return ranks.result(), theirs


def _assert_step_matches_jax(out, case, theirs):
    jparams, jmetrics = theirs
    for k in ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm"):
        np.testing.assert_allclose(float(out[f"{case}.m.{k}"]), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    for name, want in jparams.items():
        np.testing.assert_allclose(out[f"{case}.p.{name}"], want, atol=1e-4, rtol=0, err_msg=name)


def test_ddp_step_equals_jax_one_device_step(group_run):
    outs, theirs = group_run
    _assert_step_matches_jax(outs[0], "ddp_step", theirs)
    for k in outs[0]:  # the replicas agree to the bit
        if k.startswith("ddp_step."):
            np.testing.assert_array_equal(outs[0][k], outs[1][k], err_msg=k)


def test_tp_step_equals_jax_one_device_step(group_run):
    outs, theirs = group_run
    _assert_step_matches_jax(outs[0], "tp_step", theirs)
    _assert_step_matches_jax(outs[1], "tp_step", theirs)


def test_tp_synthesis_equals_replicated(group_run):
    outs, _ = group_run
    for out in outs:
        np.testing.assert_allclose(out["tp_synth.mel"], out["tp_synth.mel_ref"], atol=1e-4)
        np.testing.assert_array_equal(out["tp_synth.wav"], out["tp_synth.wav_ref"])
    assert np.abs(outs[0]["tp_synth.mel_ref"]).max() > 0


def test_dp_pipeline_equals_meshless(group_run):
    outs, _ = group_run
    for out in outs:
        for name, n in (("even", 4), ("odd", 3)):
            for i in range(n):
                ref, got = out[f"dp_pipeline.{name}.ref.{i}"], out[f"dp_pipeline.{name}.dp.{i}"]
                assert ref.shape == got.shape and ref.size > 0
                np.testing.assert_allclose(got, ref, atol=1e-4)


def test_dcp_round_trip_is_exact(group_run):
    outs, _ = group_run
    assert all(bool(out["dcp.equal"]) for out in outs)


# ---------------------------------------------------------------------- #
# slow: more ranks, the CLI, the conformer and the vocoder
# ---------------------------------------------------------------------- #

@pytest.mark.slow
def test_tp4_cut_head_step_equals_jax(group_run):
    """tp 4 cuts the tiny encoder's and decoder's heads (80 and 16 channels,
    two heads each): those attentions gather their weights, the rest split."""
    _, theirs = group_run
    sd, _ = _weights()
    inputs = {**_batch(), **{f"sd.{k}": v for k, v in sd.items()}}
    outs = worker.launch(["tp_step"], 4, inputs, SEED, timeout_s=400)
    for out in outs:
        _assert_step_matches_jax(out, "tp_step", theirs)


@pytest.mark.slow
def test_conformer_ddp_batchnorm_equals_one_device():
    """The conformer's BatchNorm statistics over the data group: after one
    DDP step on two ranks the buffers equal the one-device step's."""
    from emojivoice_tpu_torch.models.matcha import MatchaTTS

    conf = worker.conformer_cfg(CFG)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        sd = {k: v.numpy() for k, v in MatchaTTS(conf).state_dict().items()}
    inputs = {**_batch(), **{f"csd.{k}": v for k, v in sd.items()}}
    outs = worker.launch(["conformer_ddp"], 2, inputs, SEED)
    ref = worker.one_device("conformer_ddp", inputs, SEED)
    for k in ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm"):
        np.testing.assert_allclose(float(outs[0][f"conformer_ddp.m.{k}"]), ref["m"][k], rtol=1e-4, err_msg=k)
    moved = 0
    for name, want in ref["p"].items():
        got = outs[0][f"conformer_ddp.p.{name}"]
        if ".conv.net.5." in name:  # the BatchNorm weights and buffers
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)
            moved += "running" in name and not np.array_equal(want, sd[name])
        else:
            np.testing.assert_allclose(got, want, atol=1e-4, rtol=0, err_msg=name)
    assert moved == 2 * 5  # mean and variance of the five blocks


@pytest.mark.slow
def test_vocoder_step_mesh_equals_one_device():
    """The GAN step's ``mesh=``: two ranks, one row each, against the
    one-device step on both rows (the loss means over equal rows).  Metrics
    rtol 1e-4 and parameters ``tests/test_torch_vocoder_train.py``'s: atol
    4e-4 (Adam's first step moves an element by about lr = 2e-4 whatever its
    gradient's size, so a near-zero gradient summed in another order can
    flip its element's step) and the mean difference under 2e-6."""
    rng = np.random.default_rng(11)
    inputs = {"gan_mel": rng.normal(size=(2, 16, 80)).astype(np.float32),
              "gan_wav": (0.1 * rng.normal(size=(2, 16 * 256))).astype(np.float32)}
    outs = worker.launch(["vocoder_ddp"], 2, inputs, SEED)
    ref = worker.one_device("vocoder_ddp", inputs, SEED)
    for k, v in ref["m"].items():
        np.testing.assert_allclose(float(outs[0][f"vocoder_ddp.m.{k}"]), v, rtol=1e-4, err_msg=k)
    for name, want in ref["p"].items():
        got = outs[0][f"vocoder_ddp.p.{name}"]
        np.testing.assert_allclose(got, want, atol=4e-4, rtol=0, err_msg=name)
        assert np.abs(got - want).mean() < 2e-6, name


def _cli_corpus(tmp_path):
    from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset

    train, val, _ = make_alignable_dataset(tmp_path / "data", [0, 1], n_utts=3, seed=0)
    return ["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist", str(val),
            "--batch_size", "4", "--log_every", "1", "--render_val_samples", "0"]


def _records(out_dir, tag="train"):
    return [m for m in map(json.loads, (out_dir / "metrics.jsonl").read_text().splitlines()) if m["tag"] == tag]


@pytest.mark.slow
def test_train_cli_num_devices_tp_and_resume(tmp_path):
    """``--num_devices 2 --tp 2``: two local ranks, a sharded checkpoint,
    and ``--resume`` from it continues at the saved step; ``--num_devices
    1`` repeats the run without the flag exactly."""
    from emojivoice_tpu_torch.training.train import main

    base = _cli_corpus(tmp_path)
    run = tmp_path / "tp"
    assert main(base + ["--out_dir", str(run), "--max_steps", "2", "--val_every_steps", "2", "--ckpt_every_steps", "1",
                        "--num_devices", "2", "--tp", "2"]) == 0
    assert sorted(p.name for p in (run / "ckpts").glob("step_*")) == ["step_1.dcp", "step_2.dcp"]
    assert [m["step"] for m in _records(run)] == [1, 2] and len(_records(run, "val")) == 1
    assert main(base + ["--out_dir", str(run), "--max_steps", "3", "--val_every_steps", "0", "--resume",
                        "--num_devices", "2", "--tp", "2"]) == 0
    assert [m["step"] for m in _records(run)] == [1, 2, 3]
    assert np.isfinite(_records(run)[-1]["loss"])
    one, n1 = tmp_path / "one", tmp_path / "n1"
    for out, extra in ((one, []), (n1, ["--num_devices", "1"])):
        assert main(base + ["--out_dir", str(out), "--max_steps", "2", "--val_every_steps", "0"] + extra) == 0
    assert [m["loss"] for m in _records(one)] == [m["loss"] for m in _records(n1)]
    with pytest.raises(SystemExit, match="must divide the device count 2"):
        main(base + ["--out_dir", str(tmp_path / "bad"), "--num_devices", "2", "--tp", "4", "--max_steps", "1"])


@pytest.mark.slow
def test_two_process_train_cli(tmp_path):
    """Two processes over ``--dcn_*``: rank 0 logs, rank 1 stays silent,
    both exit 0, one coherent run."""
    base = _cli_corpus(tmp_path)
    out = tmp_path / "dcn"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    runner = tmp_path / "runner.py"
    runner.write_text(textwrap.dedent(f"""
        import sys
        sys.path.insert(0, {REPO!r})
        from emojivoice_tpu_torch.training.train import main
        raise SystemExit(main({base!r} + [
            "--out_dir", {str(out)!r}, "--max_steps", "1", "--val_every_steps", "1", "--ckpt_every_steps", "0",
            "--dcn_coordinator", "localhost:{port}", "--dcn_num_processes", "2", "--dcn_process_id", sys.argv[1]]))
    """))
    procs = [subprocess.Popen([sys.executable, str(runner), str(i)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(2)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert procs[0].returncode == 0, outs[0][-3000:]
    assert procs[1].returncode == 0, outs[1][-3000:]
    assert "step 1" in outs[0] and "step 1" not in outs[1]
    steps = [m["step"] for m in _records(out)]
    assert steps == [1] and np.isfinite(_records(out)[0]["loss"])
    assert sorted(p.name for p in (out / "ckpts").glob("step_*")) == ["step_1.dcp"]
