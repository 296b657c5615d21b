"""The port's HiFi-GAN discriminators and GAN losses against the JAX
package's flax modules on the CPU, at their published widths.

The flax init is carried across by ``io/from_jax.py``; waveforms come from a
numpy seed.  Every score and every feature map must agree within atol 1e-4
(f32 sums over up to 1,024 channels × 41 taps, in another order); the flax
maps are channels-last and are transposed to torch's layout for the
comparison.  An odd length (1,531 samples: no multiple of 2, 3, 5, 7 or 11)
puts every period discriminator through its reflect pad.  The three losses:
rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu.vocoder import discriminators as jd
from emojivoice_tpu_torch.io.from_jax import mpd_state_dict_from_flax, msd_state_dict_from_flax
from emojivoice_tpu_torch.vocoder import discriminators as td

torch.set_num_threads(2)

ATOL = 1e-4
B, T = 2, 1531


def _waves(seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.normal(size=(B, T))).astype(np.float32), (0.5 * rng.normal(size=(B, T))).astype(np.float32)


def _tensors(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def _nonzero_biases(params, seed):
    """flax starts biases at zero: move them, so a misplaced bias would show."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a + 0.05 * rng.normal(size=a.shape), np.float32)
        if path[-1].key == "bias" else np.asarray(a), params)


@pytest.fixture(scope="module")
def pair():
    wav = jnp.zeros((1, 256))
    out = {}
    for name, flax_mod, port_mod, bridge in (
            ("mpd", jd.MultiPeriodDiscriminator(), td.MultiPeriodDiscriminator(), mpd_state_dict_from_flax),
            ("msd", jd.MultiScaleDiscriminator(), td.MultiScaleDiscriminator(), msd_state_dict_from_flax)):
        params = _nonzero_biases(jax.device_get(flax_mod.init(jax.random.PRNGKey(len(name)), wav, wav)), 7)
        port_mod.load_state_dict(_tensors(bridge(params)), strict=True)
        out[name] = (flax_mod, params, port_mod)
    return out


def _channels_first(a):
    a = np.asarray(a)
    return np.moveaxis(a, -1, 1)


@pytest.mark.parametrize("name", ["mpd", "msd"])
def test_scores_and_feature_maps_match_flax(pair, name):
    flax_mod, params, port_mod = pair[name]
    y, y_hat = _waves(0)
    theirs = jax.device_get(jax.jit(flax_mod.apply)(params, jnp.asarray(y), jnp.asarray(y_hat)))
    with torch.no_grad():
        ours = port_mod(torch.from_numpy(y), torch.from_numpy(y_hat))
    n_sub, n_maps = (5, 6) if name == "mpd" else (3, 8)
    for side in (0, 1):  # real, generated
        assert len(ours[side]) == len(theirs[side]) == n_sub
        for a, b in zip(ours[side], theirs[side]):
            assert a.shape == b.shape
            np.testing.assert_allclose(a.numpy(), b, atol=ATOL)
        for maps_a, maps_b in zip(ours[2 + side], theirs[2 + side]):
            assert len(maps_a) == len(maps_b) == n_maps
            for a, b in zip(maps_a, maps_b):
                np.testing.assert_allclose(a.numpy(), _channels_first(b), atol=ATOL)
    if name == "mpd":  # 1,531 samples padded up to a multiple of each period
        assert [m[0].shape[2:] for m in ours[2]] == [(-(-(-(-T // p)) // 3), p) for p in (2, 3, 5, 7, 11)]


def test_avg_pool_counts_the_padding(pair):
    """flax's ``avg_pool`` divides by the window size over the zero padding:
    ``count_include_pad=True`` here.  The second scale sees exactly that."""
    y = np.ones((1, 10), np.float32)
    theirs = np.asarray(jd.nn.avg_pool(jnp.asarray(y)[..., None], (4,), strides=(2,), padding=((2, 2),))[..., 0])
    ours = pair["msd"][2].inputs(1, torch.from_numpy(y), torch.from_numpy(y))[0].numpy()
    np.testing.assert_array_equal(ours, theirs)
    assert ours[0, 0] == 0.5 and ours.shape == (1, 6)


def test_losses_match_jax(pair):
    flax_mod, params, port_mod = pair["mpd"]
    y, y_hat = _waves(1)
    r, g, fr, fg = jax.device_get(jax.jit(flax_mod.apply)(params, jnp.asarray(y), jnp.asarray(y_hat)))

    def torch_side(tree):
        return [[torch.tensor(np.asarray(a)) for a in sub] if isinstance(sub, list) else
                torch.tensor(np.asarray(sub)) for sub in tree]
    np.testing.assert_allclose(float(td.feature_loss(torch_side(fr), torch_side(fg))),
                               float(jd.feature_loss(fr, fg)), rtol=1e-5)
    ours, ours_r, ours_g = td.discriminator_loss(torch_side(r), torch_side(g))
    theirs, theirs_r, theirs_g = jd.discriminator_loss(r, g)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-5)
    np.testing.assert_allclose([float(v) for v in ours_r + ours_g], [float(v) for v in theirs_r + theirs_g],
                               rtol=1e-5)
    ours, parts = td.generator_loss(torch_side(g))
    theirs, their_parts = jd.generator_loss(g)
    np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-5)
    np.testing.assert_allclose([float(v) for v in parts], [float(v) for v in their_parts], rtol=1e-5)


def test_parameter_names_are_the_references(pair):
    names = sorted(pair["mpd"][2].state_dict())
    assert names[:4] == ["discriminators.0.conv_post.bias", "discriminators.0.conv_post.weight",
                         "discriminators.0.convs.0.bias", "discriminators.0.convs.0.weight"]
    assert pair["mpd"][2].state_dict()["discriminators.4.convs.3.weight"].shape == (1024, 512, 5, 1)
    msd = pair["msd"][2].state_dict()
    assert len(msd) == 3 * 8 * 2 and msd["discriminators.2.convs.4.weight"].shape == (1024, 32, 41)
