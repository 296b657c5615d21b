"""The vocoder's GAN step through ``training/vocoder_graphs.py`` on the CPU.

On the CPU ``VocoderGraphs`` captures nothing: ``vocoder_train_step(graphs=
True)`` runs the graph path's staging (batch-shape keys, static buffers,
invalidation on a load or a replaced parameter) with the step's body run on
the buffers.  What a capture adds on the card, replays equal to the eager
step there, is the smoke's ``[vocoder]`` (c'); here a stub graph stands in
for the card to show that a failed capture raises.

The generator is narrow (initial channel 32, ×256 upsampling) and the
discriminators run at their published widths, so the batches stay at 2 rows
of at most 16 frames.  Against the eager step the bound is equality to the
bit: the same ops on the same values.  Against the JAX step, the staged
step is a case of ``tests/test_torch_vocoder_train.py::test_gan_step_matches_jax``.

Seconds this file adds to a whole run: about 35 on one worker (32 measured
with 3 workers on a CPU host).
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch

from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.training import vocoder_train as tvt
from emojivoice_tpu_torch.training.vocoder_graphs import VocoderGraphs
from emojivoice_tpu_torch.utils.timing import StageClock

torch.set_num_threads(2)

B = 2
NARROW = dict(upsample_rates=(8, 8, 4), upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=32, num_mels=80,
              resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))
CFG = cfglib.HiFiGANConfig(**NARROW)
SEGMENTS = (8, 16, 8)  # frames of the three steps: the second at another key
METRICS = ("d_loss", "g_loss", "mel_l1", "fm_loss", "adv_loss")


def _batch(seed, frames):
    rng = np.random.default_rng(seed)
    return {"mel": torch.from_numpy((rng.normal(size=(B, frames, 80)) * 2 - 6).astype(np.float32)),
            "wav": torch.from_numpy((0.3 * rng.normal(size=(B, frames * 256))).astype(np.float32))}


def _state(**kw):
    return tvt.create_vocoder_state(CFG, seed=4, device="cpu", **kw)


def _modules(state):
    return {name: getattr(state, name) for name in ("gen", "mpd", "msd")}


@pytest.fixture(scope="module")
def stepped():
    """The same three steps from the same state, staged and eager."""
    batches = [_batch(40 + i, f) for i, f in enumerate(SEGMENTS)]
    staged, eager = _state(), _state()
    got = [tvt.vocoder_train_step(staged, b, graphs=True) for b in batches]
    want = [tvt.vocoder_train_step(eager, b) for b in batches]
    return staged, eager, got, want


def test_staged_steps_equal_eager_to_the_bit(stepped):
    """Three steps, the second at another batch shape: the five metrics of
    every step and every parameter of gen, mpd and msd after the last, and
    both Adams' moments and step counts."""
    staged, eager, got, want = stepped
    for i, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(METRICS)
        for k in METRICS:
            assert torch.equal(g[k], w[k]), (i, k, float(g[k]), float(w[k]))
    for name, module in _modules(staged).items():
        for (n, p), q in zip(module.named_parameters(), _modules(eager)[name].parameters()):
            assert torch.equal(p, q), f"{name}.{n}"
    for a, b in ((staged.gen_opt, eager.gen_opt), (staged.disc_opt, eager.disc_opt)):
        for p, q in zip(a.param_groups[0]["params"], b.param_groups[0]["params"]):
            for k in ("exp_avg", "exp_avg_sq", "step"):
                assert torch.equal(a.state[p][k], b.state[q][k]), k
    assert staged.step == eager.step == len(SEGMENTS)
    assert all(p.requires_grad for p in staged.disc_parameters())  # unfrozen again after the generator's pass


def test_keys_are_batch_shapes_and_the_cpu_default_is_eager(stepped):
    """One entry per (B, T_mel, T_wav); the third step, at the first key,
    builds nothing new; the CPU's default step is the eager one."""
    staged, eager, _, _ = stepped
    assert sorted(staged.graphs.keys()) == [(B, 8, 8 * 256), (B, 16, 16 * 256)]
    stats = staged.graphs.stats()
    assert (stats["graphs"], stats["captures"], stats["replays"], stats["drops"]) == (2, 0, 1, 0)
    assert eager.graphs is None


def test_a_cpu_state_keeps_plain_adams():
    """Plain Adams on the CPU (``capturable`` only on the card without a
    mesh), and a load keeps them so."""
    state = _state(weight_norm=False)
    for opt in (state.gen_opt, state.disc_opt):
        assert all(not g["capturable"] and isinstance(g["lr"], float) for g in opt.param_groups)
        opt.load_state_dict(opt.state_dict())
        assert all(not g["capturable"] and g["lr"] == 2e-4 for g in opt.param_groups)


def test_loads_and_replaced_parameters_drop_the_graphs():
    """A ``load_state_dict`` of either optimizer drops every graph (the
    next step builds its key anew), and so does a parameter of gen, mpd or
    msd replaced by another object."""
    state = _state(weight_norm=False)
    batch = _batch(50, 4)
    tvt.vocoder_train_step(state, batch, graphs=True)
    graphs = state.graphs
    for opt in (state.gen_opt, state.disc_opt):
        assert graphs.keys() == [(B, 4, 1024)]
        opt.load_state_dict(opt.state_dict())
        assert graphs.keys() == []
        tvt.vocoder_train_step(state, batch, graphs=True)
    assert graphs.drops == 2
    state.msd.discriminators[0].conv_post.bias = torch.nn.Parameter(state.msd.discriminators[0].conv_post.bias.clone())
    tvt.vocoder_train_step(state, batch, graphs=True)
    assert graphs.drops == 3 and graphs.keys() == [(B, 4, 1024)] and graphs.stats()["replays"] == 0


def test_mesh_and_clock_with_graphs_raise():
    state = _state(weight_norm=False)
    batch = _batch(51, 4)
    with pytest.raises(ValueError, match="clock= with graphs=True"):
        tvt.vocoder_train_step(state, batch, clock=StageClock(torch.device("cpu")), graphs=True)
    meshed = dataclasses.replace(state, mesh=object())  # the check comes before any use of the mesh
    with pytest.raises(ValueError, match="graphs=True with a mesh"):
        tvt.vocoder_train_step(meshed, batch, graphs=True)
    with pytest.raises(ValueError, match="mesh"):
        VocoderGraphs(meshed)
    assert state.graphs is None and state.step == 0


class _StubStream:
    def wait_stream(self, other):
        pass


def test_a_failed_capture_raises(monkeypatch):
    """The card's capture stubbed to fail after the warm step: the step
    raises, keeps no entry, and nothing runs the step eagerly in its place."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda keep_graph=False: object())

    @contextlib.contextmanager
    def failing(graph, pool=None, capture_error_mode="global"):
        raise RuntimeError("operation not permitted when stream is capturing")
        yield

    monkeypatch.setattr(torch.cuda, "graph", failing)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    state = _state(weight_norm=False)
    state.graphs = VocoderGraphs(state)
    state.graphs.capture = True  # what a CUDA device gives, with the stubs above for the card
    with pytest.raises(RuntimeError, match="capturing"):
        tvt.vocoder_train_step(state, _batch(52, 4), graphs=True)
    assert state.graphs.keys() == [] and state.graphs.captures == 0 and state.step == 0
