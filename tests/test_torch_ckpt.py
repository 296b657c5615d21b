"""Checkpoints into the port's pipeline: ``io/torch_ckpt.py``,
``utils/assets.py``, ``SynthesisPipeline.from_torch_checkpoints`` and
``.from_checkpoint``.

A reference-format ``.ckpt`` is written here by the JAX package
(``export_matcha_state_dict`` + ``export_matcha_hparams`` → ``torch.save``);
the port must infer a ``ModelConfig`` equal to the JAX one from it and
reproduce the JAX model's mel with injected noise (mel MAE < 1e-4 at the tiny
config, f32 on both sides).  A weight-normed HiFi-GAN dump must fold to the
bridged weights within atol 1e-6.  A one-step training run of the port's own
trainer must be servable through ``from_checkpoint``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.io import torch_ckpt as jax_ckpt
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.utils import assets as jax_assets
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.io import torch_ckpt
from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax
from emojivoice_tpu_torch.training.synthetic import make_alignable_dataset
from emojivoice_tpu_torch.training.train import main as train_main
from emojivoice_tpu_torch.utils import assets
from tests.test_torch_serving import flax_tiny_params, port_root

torch.set_num_threads(2)

BUCKETS = dict(mel_buckets=(64, 128, 256), text_buckets=(64, 128))


def as_tensors(sd):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in sd.items()}


def weight_normed(sd, rng):
    """A folded generator state dict re-split into weight_g / weight_v, as the
    reference's dumps store it: v is the weight scaled by a random positive
    factor per dim-0 slice, g the weight's norm over the other dims."""
    out = {}
    for k, v in sd.items():
        if not k.endswith(".weight"):
            out[k] = torch.from_numpy(np.asarray(v).copy())
            continue
        w = np.asarray(v, np.float64)
        axes = tuple(range(1, w.ndim))
        scale = rng.uniform(0.5, 2.0, size=(w.shape[0],) + (1,) * (w.ndim - 1))
        out[k[: -len("weight")] + "weight_g"] = torch.from_numpy(
            np.sqrt((w ** 2).sum(axis=axes, keepdims=True)).astype(np.float32))
        out[k[: -len("weight")] + "weight_v"] = torch.from_numpy((w * scale).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The tiny flax init, exported to reference-format files by the JAX package."""
    jax_root, params, voc_params = flax_tiny_params()
    folder = tmp_path_factory.mktemp("ckpts")
    sd = jax_ckpt.export_matcha_state_dict(params, jax_root.model)
    torch.save({"state_dict": as_tensors(sd), "hyper_parameters": jax_ckpt.export_matcha_hparams(jax_root.model)},
               folder / "matcha.ckpt")
    torch.save({"state_dict": as_tensors(sd)}, folder / "matcha_no_hparams.ckpt")
    voc_sd = hifigan_state_dict_from_flax(voc_params, port_root(jax_root).vocoder)
    torch.save({"generator": weight_normed(voc_sd, np.random.default_rng(0))}, folder / "generator_v1")
    return jax_root, params, voc_params, voc_sd, folder


def test_inferred_config_equals_the_jax_config(exported):
    jax_root, params, _, _, folder = exported
    sd, cfg = torch_ckpt.load_matcha(str(folder / "matcha.ckpt"))
    assert cfglib.to_dict(cfg) == jax_cfglib.to_dict(jax_root.model)
    # the same inference in the JAX package, from the same file
    jax_cfg = jax_ckpt.load_matcha_params(str(folder / "matcha.ckpt"))[1]
    assert cfglib.to_dict(cfg) == jax_cfglib.to_dict(jax_cfg)
    bridged = matcha_state_dict_from_flax(params, cfg)
    assert sorted(sd) == sorted(bridged)
    for k in sd:
        np.testing.assert_array_equal(sd[k].numpy(), bridged[k], err_msg=k)
    # without embedded hyper-parameters the shapes and the reference defaults decide, as in the JAX package
    obj = torch_ckpt.load_torch_file(str(folder / "matcha_no_hparams.ckpt"))
    assert torch_ckpt.extract_hyper_parameters(obj) is None
    bare = torch_ckpt.infer_model_config_from_state_dict(torch_ckpt.state_dict_arrays(obj))
    jax_bare = jax_ckpt.infer_model_config_from_state_dict(jax_ckpt.load_torch_state_dict(
        str(folder / "matcha_no_hparams.ckpt")))
    assert cfglib.to_dict(bare) == jax_cfglib.to_dict(jax_bare)


@pytest.mark.parametrize("case", ["n_spks", "heads", "enc_heads", "partial", "zero_dropout"])
def test_hyper_parameters_are_cross_checked_as_in_jax(exported, case):
    jax_root, _, _, _, folder = exported
    sd = torch_ckpt.load_torch_state_dict(str(folder / "matcha.ckpt"))
    jax_sd = {k: v.numpy() for k, v in sd.items()}
    hp = jax_ckpt.export_matcha_hparams(jax_root.model)
    rows = sd["decoder.estimator.down_blocks.0.1.0.attn1.to_q.weight"].shape[0]
    if case == "n_spks":
        hp["n_spks"] = 99
    elif case == "heads":
        hp["decoder"].update(num_heads=3, attention_head_dim=7)
    elif case == "enc_heads":
        hp["encoder"]["encoder_params"]["n_heads"] = 5
    elif case == "partial":  # one half of the head split given: the other follows from the row count
        hp["decoder"].pop("attention_head_dim")
        hp["decoder"]["num_heads"] = 1
    else:
        hp["encoder"]["encoder_params"]["p_dropout"] = 0.0  # a stored 0.0 is kept, not replaced by the default
        hp["encoder"]["duration_predictor_params"].pop("p_dropout")  # then shared with the encoder's
        hp["decoder"]["dropout"] = 0.0
    if case in ("n_spks", "heads", "enc_heads"):
        with pytest.raises(ValueError) as ours:
            torch_ckpt.infer_model_config_from_state_dict(sd, hp)
        with pytest.raises(ValueError) as theirs:
            jax_ckpt.infer_model_config_from_state_dict(jax_sd, hp)
        assert str(ours.value) == str(theirs.value)
        return
    cfg = torch_ckpt.infer_model_config_from_state_dict(sd, hp)
    assert cfglib.to_dict(cfg) == jax_cfglib.to_dict(jax_ckpt.infer_model_config_from_state_dict(jax_sd, hp))
    if case == "partial":
        assert (cfg.decoder.num_heads, cfg.decoder.attention_head_dim) == (1, rows)
    else:
        assert cfg.encoder.p_dropout == 0.0 == cfg.decoder.dropout and cfg.duration_predictor.p_dropout == 0.0


def test_from_torch_checkpoints_reproduces_the_jax_mel(exported, rng):
    jax_root, params, voc_params, voc_sd, folder = exported
    pipe = SynthesisPipeline.from_torch_checkpoints(
        str(folder / "matcha.ckpt"), str(folder / "generator_v1"), vocoder_cfg=port_root(jax_root).vocoder,
        device="cpu", cleaners=("basic_cleaners",), **BUCKETS)
    assert cfglib.to_dict(pipe.model_cfg) == jax_cfglib.to_dict(jax_root.model)
    # the weight-normed dump folds to the bridged weights
    loaded = pipe.vocoder.state_dict()
    assert sorted(loaded) == sorted(voc_sd)
    for k, v in voc_sd.items():
        np.testing.assert_allclose(loaded[k].numpy(), v, atol=1e-6, err_msg=k)

    texts, spks, ty, steps = ["hello there", "a longer sentence here"], [1, 3], 128, 2
    x, xl, _, _ = pipe.encode_texts(texts)
    z = rng.normal(size=(2, ty, 12)).astype(np.float32) * 0.667
    model = FlaxMatcha(cfg=jax_root.model)
    ref = jax.device_get(jax.jit(lambda x, xl, spks, z: model.apply(
        params, x, xl, ty, steps, 0.667, spks, 1.0, None, z, method=FlaxMatcha.synthesise))(
        jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32), jnp.asarray(spks, jnp.int32), jnp.asarray(z)))
    got = pipe.model.synthesise(torch.from_numpy(x), torch.from_numpy(xl), ty, steps, torch.from_numpy(z),
                                torch.tensor(spks))
    np.testing.assert_array_equal(got["mel_lengths"].numpy(), ref["mel_lengths"])
    for i, ml in enumerate(ref["mel_lengths"]):
        assert np.abs(got["mel"][i, :ml].numpy() - ref["mel"][i, :ml]).mean() < 1e-4
    res = pipe.synthesise(texts, spks=spks, n_timesteps=2, seed=0)
    assert all(np.isfinite(r.wav).all() and r.wav.shape == (r.mel_length * 16,) for r in res)


def test_from_torch_checkpoints_without_a_vocoder_takes_a_seeded_random_one(exported):
    jax_root, _, _, _, folder = exported
    kw = dict(vocoder_cfg=port_root(jax_root).vocoder, device="cpu", cleaners=("basic_cleaners",), **BUCKETS)
    with pytest.warns(UserWarning, match="random HiFi-GAN"):
        a = SynthesisPipeline.from_torch_checkpoints(str(folder / "matcha.ckpt"), **kw)
    with pytest.warns(UserWarning, match="random HiFi-GAN"):
        b = SynthesisPipeline.from_torch_checkpoints(str(folder / "matcha.ckpt"), **kw)
    torch.manual_seed(123)  # the global generator does not reach the vocoder's seed, nor the other way round
    wa, wb = (p.synthesise(["seeded vocoder"], spks=[1], n_timesteps=2, seed=0)[0].wav for p in (a, b))
    np.testing.assert_array_equal(wa, wb)
    assert torch.initial_seed() == 123 and np.abs(wa).max() > 0
    # the default vocoder config is HiFi-GAN v1 at the model's mel width
    default = dataclasses.replace(cfglib.HiFiGANConfig(), num_mels=12)
    assert default.upsample_rates == (8, 8, 2, 2) and default.total_upsample == 256


@pytest.mark.filterwarnings("ignore:.*weight_norm.*:FutureWarning")
def test_fold_weight_norm_matches_torch(rng):
    for conv in (torch.nn.Conv1d(4, 6, 3), torch.nn.ConvTranspose1d(6, 4, 8, 4, padding=2)):
        conv = torch.nn.utils.weight_norm(conv)
        g, v = conv.weight_g.detach().clone(), conv.weight_v.detach().clone()
        torch.nn.utils.remove_weight_norm(conv)
        np.testing.assert_allclose(torch_ckpt.fold_weight_norm_torch(g, v).numpy(), conv.weight.detach().numpy(),
                                   atol=1e-6)
        np.testing.assert_allclose(torch_ckpt.fold_weight_norm_torch(g, v).numpy(),
                                   jax_ckpt.fold_weight_norm_torch(g.numpy(), v.numpy()), atol=1e-7)
    sd = {"a.weight_g": torch.ones(2, 1, 1), "a.weight_v": torch.full((2, 3, 1), 2.0), "a.bias": torch.zeros(2),
          "b.weight": torch.ones(2, 2, 1)}
    folded = torch_ckpt.fold_hifigan_state_dict(sd)
    assert sorted(folded) == ["a.bias", "a.weight", "b.weight"]
    np.testing.assert_allclose(folded["a.weight"].numpy(), np.full((2, 3, 1), 1 / np.sqrt(3)), atol=1e-7)


def test_loader_unwraps_and_refuses_pickled_objects(tmp_path):
    nested = {"encoder": {"emb": {"weight": torch.ones(3, 2, dtype=torch.float64)}}, "step": 7}
    torch.save(nested, tmp_path / "bare.pt")
    flat = torch_ckpt.load_torch_state_dict(str(tmp_path / "bare.pt"))
    assert list(flat) == ["encoder.emb.weight"] and flat["encoder.emb.weight"].dtype == torch.float32
    torch.save({"generator": {"conv_pre.bias": torch.zeros(2)}, "steps": 1}, tmp_path / "gen.pt")
    assert list(torch_ckpt.load_torch_state_dict(str(tmp_path / "gen.pt"))) == ["conv_pre.bias"]
    torch.save({"state_dict": {}, "hyper_parameters": CheckpointManager}, tmp_path / "pickled.ckpt")
    with pytest.raises(RuntimeError, match="weights_only"):
        torch_ckpt.load_torch_file(str(tmp_path / "pickled.ckpt"))


def test_trained_checkpoint_is_served(tmp_path):
    """What ``emojivoice_tpu_torch.training.train`` wrote, served: a one-step
    run at the tiny preset, then ``from_checkpoint`` on its ``ckpts/``."""
    train, val, _ = make_alignable_dataset(tmp_path / "corpus", [0, 1], n_utts=2, seed=0)
    out = tmp_path / "run"
    assert train_main(["--preset", "tiny", "--device", "cpu", "--train_filelist", str(train), "--valid_filelist",
                       str(val), "--out_dir", str(out), "--batch_size", "2", "--max_steps", "1", "--probe_every", "0",
                       "--val_every_steps", "0"]) == 0
    mgr = CheckpointManager(str(out / "ckpts"))
    assert mgr.all_steps() == [1]
    # a narrow vocoder in the run's config keeps the CPU's work small
    root = mgr.load_config()
    narrow = dataclasses.replace(root.vocoder, upsample_initial_channel=32)
    mgr.save(1, mgr.restore(1), cfg=dataclasses.replace(root, vocoder=narrow))
    with pytest.warns(UserWarning, match="random HiFi-GAN"):
        pipe = SynthesisPipeline.from_checkpoint(str(out / "ckpts"), device="cpu", cleaners=("basic_cleaners",),
                                                 **BUCKETS)
    assert pipe.vocoder_cfg == narrow and cfglib.to_dict(pipe.model_cfg) == cfglib.to_dict(root.model)
    trained = mgr.restore(1)["model"]
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(v, trained[k]), k
    res = pipe.synthesise(["served after training"], spks=[1], n_timesteps=2, seed=0)[0]
    assert res.mel_length > 0 and res.wav.shape == (res.mel_length * 256,) and np.isfinite(res.wav).all()
    # with a vocoder dump, and an explicit step
    torch.save({"generator": weight_normed({k: v.numpy() for k, v in pipe.vocoder.state_dict().items()},
                                            np.random.default_rng(1))}, tmp_path / "g_narrow")
    again = SynthesisPipeline.from_checkpoint(str(out / "ckpts"), str(tmp_path / "g_narrow"), step=1, device="cpu",
                                              cleaners=("basic_cleaners",), **BUCKETS)
    res2 = again.synthesise(["served after training"], spks=[1], n_timesteps=2, seed=0)[0]
    np.testing.assert_allclose(res2.wav, res.wav, atol=1e-4)
    with pytest.raises(FileNotFoundError):
        SynthesisPipeline.from_checkpoint(str(out / "ckpts"), step=5, device="cpu")


# ---------------------------------------------------------------------------
# assets (local paths only)
# ---------------------------------------------------------------------------

def test_resolve_model_through_the_cache_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("EMOJIVOICE_HOME", str(tmp_path / "home"))
    cache = assets.get_user_data_dir()
    assert cache == jax_assets.get_user_data_dir() == (tmp_path / "home" / "emojivoice").resolve() and cache.is_dir()
    assert assets.ASSET_URLS == jax_assets.ASSET_URLS
    assert assets.resolve_model(None) is None
    local = tmp_path / "mine.ckpt"
    local.write_bytes(b"x")
    assert assets.resolve_model(str(local)) == str(local)
    assert assets.resolve_model(str(tmp_path)) == str(tmp_path)  # a checkpoint directory passes through
    (cache / "emoji-hri-paige.ckpt").write_bytes(b"x")
    assert assets.resolve_model("emoji-hri-paige.ckpt") == str(cache / "emoji-hri-paige.ckpt")
    assert assets.resolve_model("some/where/emoji-hri-paige.ckpt") == str(cache / "emoji-hri-paige.ckpt")
    # absent files: the JAX package's error texts
    for name, kind, exc in (("nowhere.ckpt", "checkpoint", FileNotFoundError),
                            ("hifigan_univ_v1", "vocoder", RuntimeError)):
        with pytest.raises(exc) as ours:
            assets.resolve_model(name, kind, allow_fetch=False)
        with pytest.raises(exc) as theirs:
            jax_assets.resolve_model(name, kind, allow_fetch=False)
        assert str(ours.value) == str(theirs.value) and str(cache) in str(ours.value)


# ---------------------------------------------------------------------------
# the vocoder's training side: generator dumps kept unfolded, do_* discriminator files
# ---------------------------------------------------------------------------

def test_load_hifigan_unfolded_keeps_or_makes_the_weight_norm_pair(exported, tmp_path):
    jax_root, _, voc_params, voc_sd, folder = exported
    from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    cfg = port_root(jax_root).vocoder
    kept = torch_ckpt.load_hifigan(str(folder / "generator_v1"), fold=False)
    stored = torch_ckpt.load_torch_state_dict(str(folder / "generator_v1"))
    assert sorted(kept) == sorted(stored) and all(torch.equal(kept[k], stored[k]) for k in stored)
    gen = HiFiGANGenerator(cfg, weight_norm=True)
    gen.load_state_dict(kept, strict=True)
    # the weight it computes is the folded one, which is the bridged flax kernel
    np.testing.assert_allclose(gen.conv_pre.weight.detach().numpy(), voc_sd["conv_pre.weight"], atol=1e-6)
    np.testing.assert_allclose(gen.ups[0].weight.detach().numpy(), voc_sd["ups.0.weight"], atol=1e-6)
    # a dump that was folded already: v = w, g = ‖w‖ over all but the first axis, as the JAX loader makes them
    torch.save({"generator": as_tensors(voc_sd)}, tmp_path / "folded")
    made = torch_ckpt.load_hifigan(str(tmp_path / "folded"), fold=False)
    assert sorted(made) == sorted(kept)
    for name in ("conv_post", "ups.1", "resblocks.2.convs1.0"):
        v, g = jax_ckpt._vg(voc_sd, name)
        np.testing.assert_array_equal(made[f"{name}.weight_v"].numpy(), v)
        np.testing.assert_allclose(made[f"{name}.weight_g"].numpy(), g, atol=1e-7)
    gen.load_state_dict(made, strict=True)
    np.testing.assert_allclose(gen.fold_weight_norm().state_dict()["ups.1.weight"].numpy(), voc_sd["ups.1.weight"],
                               atol=1e-6)


@pytest.mark.filterwarnings("ignore:.*weight_norm.*:FutureWarning")
def test_load_hifigan_discriminators_makes_every_weight_plain(tmp_path):
    """A ``do_*`` file in the upstream naming, written here: weight norm on
    the period discriminators and on scales 1-2, spectral norm on scale 0
    (settled by power iteration).  Every loaded weight must be the one the
    upstream module computes in eval mode (atol 1e-6), and equal what the JAX
    package's loader makes of the same entries."""
    from emojivoice_tpu_torch.training.vocoder_train import create_vocoder_state
    from emojivoice_tpu_torch.vocoder.discriminators import MultiPeriodDiscriminator, MultiScaleDiscriminator

    torch.manual_seed(0)
    mpd, msd = MultiPeriodDiscriminator(), MultiScaleDiscriminator()
    for d in mpd.discriminators:
        for conv in list(d.convs) + [d.conv_post]:
            torch.nn.utils.weight_norm(conv)
    for i, d in enumerate(msd.discriminators):
        for conv in list(d.convs) + [d.conv_post]:
            (torch.nn.utils.spectral_norm if i == 0 else torch.nn.utils.weight_norm)(conv)
    wav = torch.randn(1, 2048)
    with torch.no_grad():
        for _ in range(30):  # power iterations of the spectral-norm vectors, in train mode
            msd.discriminators[0](wav)
        mpd.eval(), msd.eval()
        mpd(wav, wav), msd(wav, wav)  # eval mode computes each effective weight from what is stored
    path = tmp_path / "do_00000001"
    torch.save({"mpd": mpd.state_dict(), "msd": msd.state_dict(), "steps": 1, "epoch": 0}, path)
    names = list(msd.state_dict())
    assert "discriminators.0.convs.0.weight_orig" in names and "discriminators.1.convs.0.weight_g" in names

    loaded = torch_ckpt.load_hifigan_discriminators(str(path))
    plain = {"mpd": MultiPeriodDiscriminator(), "msd": MultiScaleDiscriminator()}
    for key, module in (("mpd", mpd), ("msd", msd)):
        assert sorted(loaded[key]) == sorted(plain[key].state_dict())
        raw = {k: v.numpy() for k, v in module.state_dict().items()}
        for name, sub in module.named_modules():
            if isinstance(sub, (torch.nn.Conv1d, torch.nn.Conv2d)):
                got = loaded[key][f"{name}.weight"].numpy()
                np.testing.assert_allclose(got, sub.weight.detach().numpy(), atol=1e-6, err_msg=f"{key}.{name}")
                np.testing.assert_allclose(got, jax_ckpt._effective_weight(raw, name), atol=1e-6)
                assert torch.equal(loaded[key][f"{name}.bias"], sub.bias)
    # some torch versions store no weight_v for spectral norm: it is recomputed from u (equal once settled)
    sd = {k: v for k, v in msd.state_dict().items() if not (k.startswith("discriminators.0.") and k.endswith("_v"))}
    torch.save({"mpd": mpd.state_dict(), "msd": sd}, tmp_path / "do_no_v")
    again = torch_ckpt.load_hifigan_discriminators(str(tmp_path / "do_no_v"))
    np.testing.assert_allclose(again["msd"]["discriminators.0.convs.3.weight"].numpy(),
                               loaded["msd"]["discriminators.0.convs.3.weight"].numpy(), atol=1e-4)
    # it warm-starts the training state, strictly
    cfg = cfglib.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=16)
    state = create_vocoder_state(cfg, device="cpu", disc_state=loaded)
    assert torch.equal(state.msd.discriminators[0].convs[0].weight, loaded["msd"]["discriminators.0.convs.0.weight"])
    torch.save({"generator": {"conv_pre.bias": torch.zeros(2)}}, tmp_path / "g_only")
    with pytest.raises(ValueError, match="not a HiFi-GAN do_"):
        torch_ckpt.load_hifigan_discriminators(str(path.parent / "g_only"))
