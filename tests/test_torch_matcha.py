"""Port's acoustic model (encoder, duration head, CFM decode) against the
JAX ``MatchaTTS`` on the same weights (through ``io/from_jax.py``) and the
same injected noise ``z``.

Tolerances: ``mel_lengths`` equal; ``attn`` within atol 1e-5; mel-MAE below
1e-4 at the tiny config and 1e-3 at emoji_multi width — both well under the
BASELINE ceiling of 1e-2 (``BASELINE.md:30``).  The differences are f32
summation order between XLA and PyTorch's CPU kernels.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu.config import get_preset
from emojivoice_tpu.io.torch_ckpt import export_matcha_state_dict
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu_torch.io.from_jax import matcha_state_dict_from_flax
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from tests.test_models import tiny_cfg

torch.set_num_threads(2)


def _make_pair(cfg):
    model = FlaxMatcha(cfg=cfg)
    # initialised through the inference path, jitted: the cheapest compile
    init = jax.jit(lambda rng: model.init(
        {"params": rng}, jnp.ones((1, 8), jnp.int32), jnp.array([8]), 16, 1, 1.0, jnp.array([0]), 1.0, None,
        jnp.zeros((1, 16, cfg.n_feats)), method=FlaxMatcha.synthesise))
    params = jax.device_get(init(jax.random.PRNGKey(0)))
    port = MatchaTTS(cfg)
    port.load_state_dict({k: torch.tensor(v) for k, v in matcha_state_dict_from_flax(params, cfg).items()},
                         strict=True)
    return model, params, port.eval()


@pytest.fixture(scope="module")
def tiny_pair():
    return _make_pair(tiny_cfg())  # n_spks=3, n_feats=12, 2 encoder layers, (16, 16) decoder


def _batch(rng, cfg, tx, ty, lengths, spks):
    x = np.zeros((len(lengths), tx), np.int64)
    for i, n in enumerate(lengths):
        x[i, :n] = rng.integers(1, 170, n)
    z = rng.normal(size=(len(lengths), ty, cfg.n_feats)).astype(np.float32) * 0.667
    return x, np.asarray(lengths, np.int64), np.asarray(spks, np.int64), z


def _jax_synth(model, params, x, xl, spks, ty, steps, z):
    return model.apply({"params": params["params"]}, jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32), ty,
                       steps, 0.667, jnp.asarray(spks, jnp.int32), 1.0, None, jnp.asarray(z),
                       method=FlaxMatcha.synthesise)


def _assert_synth_close(ours, theirs, mae_bound):
    ml = np.asarray(theirs["mel_lengths"])
    np.testing.assert_array_equal(ours["mel_lengths"].numpy(), ml)
    np.testing.assert_allclose(ours["attn"].numpy(), np.asarray(theirs["attn"]), atol=1e-5)
    for i, n in enumerate(ml):
        mae = float(np.abs(ours["mel"][i, :n].numpy() - np.asarray(theirs["mel"][i, :n])).mean())
        assert mae < mae_bound, f"row {i}: mel-MAE {mae} over {mae_bound}"


def test_state_dict_names_match_export(tiny_pair):
    """The bridge names and lays out every tensor as the JAX package's
    reference export does — the naming a released ``.ckpt`` loads through."""
    model, params, _ = tiny_pair
    ours = matcha_state_dict_from_flax(params, tiny_cfg())
    ref = export_matcha_state_dict(params, tiny_cfg())
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_encode_text_matches(tiny_pair, rng):
    model, params, port = tiny_pair
    cfg = tiny_cfg()
    x, xl, spks, _ = _batch(rng, cfg, 16, 8, [10, 16], [2, 0])
    mu_j, w_j, yl_j, xm_j, spk_j = model.apply(
        {"params": params["params"]}, jnp.asarray(x, jnp.int32), jnp.asarray(xl, jnp.int32),
        jnp.asarray(spks, jnp.int32), 1.0, method=FlaxMatcha.encode_text)
    mu, w, yl, xm, spk = port.encode_text(torch.from_numpy(x), torch.from_numpy(xl), torch.from_numpy(spks))
    np.testing.assert_allclose(mu.numpy(), np.asarray(mu_j), atol=2e-5)
    np.testing.assert_array_equal(w.numpy(), np.asarray(w_j))
    np.testing.assert_array_equal(yl.numpy(), np.asarray(yl_j))
    np.testing.assert_array_equal(xm.numpy(), np.asarray(xm_j))
    np.testing.assert_allclose(spk.numpy(), np.asarray(spk_j), atol=0)


@pytest.mark.parametrize("steps,tx_len", [(2, 12), (4, 16)])
def test_synthesise_matches(tiny_pair, steps, tx_len):
    model, params, port = tiny_pair
    cfg = tiny_cfg()
    rng = np.random.default_rng(steps)
    x, xl, spks, z = _batch(rng, cfg, 16, 48, [tx_len, tx_len - 4], [1, 2])
    theirs = _jax_synth(model, params, x, xl, spks, 48, steps, z)
    ours = port.synthesise(torch.from_numpy(x), torch.from_numpy(xl), 48, steps, torch.from_numpy(z),
                           torch.from_numpy(spks))
    _assert_synth_close(ours, theirs, 1e-4)


def test_two_stage_decode_matches_fused(tiny_pair, rng):
    """encode_text → decode_mel (the two-stage path) equals synthesise."""
    _, _, port = tiny_pair
    cfg = tiny_cfg()
    x, xl, spks, z = _batch(rng, cfg, 16, 48, [9, 14], [0, 1])
    args = torch.from_numpy(x), torch.from_numpy(xl)
    fused = port.synthesise(*args, 48, 2, torch.from_numpy(z), torch.from_numpy(spks))
    enc = port.encode_text(*args, torch.from_numpy(spks))
    staged = port.decode_mel(*enc, 48, 2, torch.from_numpy(z))
    for k in ("mel", "attn", "mel_lengths"):
        torch.testing.assert_close(staged[k], fused[k], atol=0, rtol=0)


def test_synthesise_matches_at_emoji_multi_width(rng):
    """Production widths: 109 speakers, 192-channel 6-layer encoder, 768
    filter channels, (256, 256) decoder — catches size-dependent drift such
    as the int(head_dim·0.5) RoPE truncation.  Short sequences keep it cheap."""
    cfg = get_preset("emoji_multi").model
    model, params, port = _make_pair(cfg)
    x, xl, spks, z = _batch(rng, cfg, 16, 48, [14, 10], [79, 107])
    theirs = _jax_synth(model, params, x, xl, spks, 48, 2, z)
    ours = port.synthesise(torch.from_numpy(x), torch.from_numpy(xl), 48, 2, torch.from_numpy(z),
                           torch.from_numpy(spks))
    _assert_synth_close(ours, theirs, 1e-3)
