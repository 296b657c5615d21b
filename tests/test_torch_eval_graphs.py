"""The forwards of ``training/eval_graphs.py`` on the CPU, at the ``tiny``
preset: the eval step, the trainer's probe and ``get_durations``' forward.

On the CPU ``EvalGraphs`` captures nothing: each key's static inputs and
fixed draws are made at its first call, and the body runs on them every
call.  That staging must give the eager forward's values to the bit, also
when a graphed train step (``training/graphs.py``) has moved the weights,
and the conformer's BatchNorm statistics, in place between two calls.  The
drops (an optimizer load where the graphs follow it, a sharded-format load,
a parameter replaced by another object or another storage) are shown here;
a stub ``torch.cuda.CUDAGraph`` stands in for the card to show one capture
per key, K2 counted once a replay, and outputs copied out of the graph's
memory.  What a capture adds on the card (a replay equal to the eager
forward there) is the smoke's ``[train_graphs]`` (f) and vocoder (a).

About 20 s on this CPU.
"""

import contextlib
import copy

import numpy as np
import pytest
import torch

from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.models import matcha
from emojivoice_tpu_torch.ops import mas
from emojivoice_tpu_torch.training import eval_graphs as eg
from emojivoice_tpu_torch.training import get_durations
from emojivoice_tpu_torch.training.eval_graphs import EvalGraphs, graphs_for
from emojivoice_tpu_torch.training.state import batch_to_device, create_train_state, eval_step, train_step
from emojivoice_tpu_torch.utils.prng import step_generator
from tests.test_torch_train_graphs import _cfg, _np_batch

torch.set_num_threads(2)

SEED = 7
KEYS = ((2, 12, 32), (3, 8, 16))  # (B, T_text, T_mel) of the two interleaved keys
ORDER = (0, 1, 0, 1)
LOSSES = ("dur_loss", "prior_loss", "diff_loss", "loss")


def _batches(order=ORDER, base=100):
    return [batch_to_device(_np_batch(*KEYS[k], seed=base + i), "cpu") for i, k in enumerate(order)]


def _state(decoder="transformer"):
    return create_train_state(_cfg(decoder), cfglib.OptimizerConfig(), seed=SEED, device="cpu")


def _equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), (k, got[k], want[k])


@pytest.mark.parametrize("decoder, precision", [("transformer", "f32"), ("conformer", "f32"),
                                                ("transformer", "bf16-mixed")])
def test_staged_eval_step_equals_eager_as_the_weights_move(decoder, precision):
    """Two keys interleaved, each eval between two graphed (staged) train
    steps: the staged eval step gives the eager one's losses to the bit
    after every step, so it reads the weights, and the conformer's
    BatchNorm statistics, as the train step left them; two keys, every
    later call replays; the model's mode is restored."""
    state = _state(decoder)
    model = state.model
    train, evals = _batches(), _batches(base=300)
    graphs = graphs_for(model)
    seen = []
    for tb, vb in zip(train, evals):
        train_step(state, tb, SEED, precision=precision, graphs=True)
        assert model.training
        got = eval_step(model, vb, precision=precision, graphs=True)
        _equal(got, eval_step(model, vb, precision=precision, graphs=False))
        assert model.training
        seen.append(float(got["loss"]))
    assert len(set(seen)) == len(seen)  # the weights moved between the calls
    assert sorted(k[0][1:5] for k in graphs.entries()) == sorted((*KEYS[k], precision) for k in (0, 1))
    assert graphs.stats()["replays"] == len(ORDER) - 2 and graphs.captures == 0 and graphs.drops == 0
    if decoder == "conformer":
        assert any("running_mean" in n and float(x.abs().sum()) > 0 for n, x in model.named_buffers())


def test_eval_step_keys_the_seed_and_optional_fields_and_the_cpu_default_is_eager():
    """The eval draws are the seed's: another seed is another key with its
    own draws, as is a batch that carries a row mask; without ``graphs`` the
    CPU runs eagerly and makes no cache; over a mesh ``graphs=True`` raises."""
    state = _state()
    model = state.model
    batch = _batches()[0]
    eval_step(model, batch)
    assert eg.existing(model) is None
    for seed in (0, 5):
        _equal(eval_step(model, batch, seed=seed, graphs=True), eval_step(model, batch, seed=seed, graphs=False))
    masked = dict(batch, row_mask=torch.tensor([1.0, 0.0]))
    _equal(eval_step(model, masked, graphs=True), eval_step(model, masked, graphs=False))
    keys = [k[0] for k in graphs_for(model).entries()]
    assert len(keys) == 3 and {k[-1] for k in keys} == {0, 5} and {k[-2] for k in keys} == {("spks",), ("spks", "row_mask")}
    model.data_group = object()  # any object stands for a mesh's group: refused before it is used
    with pytest.raises(ValueError, match="mesh"):
        eval_step(model, batch, graphs=True)
    with pytest.raises(ValueError, match="mesh"):
        EvalGraphs(model)


def test_staged_probe_equals_the_eager_probe():
    """The trainer's probe on its fixed batch and noise, between train steps:
    every output equal to ``training_probe``'s in eval mode."""
    state = _state("conformer")
    model = state.model
    probe = _batches(order=(0,), base=500)[0]
    z = torch.randn(probe["y"].shape, generator=step_generator(0, 0, "probe", "cpu")) * 0.667
    graphs = graphs_for(model)
    for tb in _batches(order=(0, 1, 0)):
        got = graphs.probe(probe, z)
        model.eval()
        want = model.training_probe(probe["x"], probe["x_lengths"], probe["y"], probe["y_lengths"], probe["spks"],
                                    z=z)
        model.train()
        _equal(got, want)
        train_step(state, tb, SEED, graphs=True)
    assert graphs.keys() == [("probe", 10)] and graphs.stats()["replays"] == 2


def test_loads_and_replaced_weights_drop_the_graphs():
    """A load of the followed optimizer's state, a sharded-format load, a
    parameter replaced by another object and one whose storage is replaced
    each drop every graph; the next call builds its key again and is still
    equal to the eager step."""
    state = _state()
    model = state.model
    batch = _batches()[0]
    graphs = graphs_for(model).follow(state.optimizer)

    def call():
        _equal(eval_step(model, batch, graphs=True), eval_step(model, batch, graphs=False))
        assert len(graphs.keys()) == 1

    call()
    train_step(state, batch, SEED, graphs=True)
    call()
    assert graphs.drops == 0
    state.optimizer.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    assert graphs.keys() == [] and graphs.drops == 1
    call()
    opt = state.optimizer
    sd = {"model": {k: v.clone() for k, v in model.state_dict().items()},
          "optimizer": {n: {k: v.clone() for k, v in opt.state[p].items()} for n, p in model.named_parameters()},
          "step": torch.tensor(state.step)}
    state.load_sharded_state_dict(sd)
    assert graphs.keys() == [] and graphs.drops == 2
    call()
    model.load_state_dict(model.state_dict(), assign=True)
    call()
    assert graphs.drops == 3
    p = next(model.parameters())
    p.data = p.data.clone()
    call()
    assert graphs.drops == 4


def _ckpt(tmp_path):
    """A trainer's ``ckpts/`` folder holding the tiny model from a seed, and
    a filelist of the seeded synthetic corpus."""
    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.training.proof import make_dataset

    train_fl, _ = make_dataset(tmp_path / "data", tuple(range(4)), n_utts=5, seconds=1.0, seed=0)
    root = cfglib.get_preset("tiny")
    state = create_train_state(root.model, cfglib.OptimizerConfig(), seed=3, device="cpu")
    CheckpointManager(str(tmp_path / "ckpts")).save(1, {"model": state.model.state_dict(), "step": 1}, cfg=root)
    return tmp_path / "ckpts", train_fl


@pytest.mark.parametrize("gen_mels", [False, True])
def test_get_durations_staged_equals_eager_to_the_bit(tmp_path, capsys, gen_mels):
    """``get_durations`` through its staged forward (the default) against
    ``--eager``: every durations file and teacher-forced mel equal to the
    bit."""
    ckpt, filelist = _ckpt(tmp_path)
    extra = ["--gen_mels", "--n_timesteps", "2"] if gen_mels else []
    outs = {}
    for mode in ("graphs", "eager"):
        outs[mode] = tmp_path / mode
        argv = ["--checkpoint_path", str(ckpt), "--filelist", str(filelist), "--preset", "tiny", "--output_dir",
                str(outs[mode]), "--batch_size", "2", "--device", "cpu", *extra] + (["--eager"] if mode == "eager"
                                                                                     else [])
        assert get_durations.main(argv) == 0
    said = [line for line in capsys.readouterr().out.splitlines() if "staged keys" in line]
    assert len(said) == 1 and "0 captures" in said[0]
    files = sorted(p.relative_to(outs["eager"]) for p in outs["eager"].rglob("*.npy"))
    assert len(files) == 5 * (2 if gen_mels else 1)
    for f in files:
        np.testing.assert_array_equal(np.load(outs["graphs"] / f), np.load(outs["eager"] / f), err_msg=str(f))


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: a replay runs the
    captured body (``on_replay``)."""

    def __init__(self, keep_graph=False):
        self.on_replay = None

    def replay(self):
        self.on_replay()


class _StubStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stub_card(monkeypatch):
    """The card's graph calls stubbed, K2 counted as its wrapper counts it
    on the card, and a capture that runs its body (its outputs become the
    static ones) and hands a replay the same body."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, pool=None, capture_error_mode="global":
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    real_path = matcha.maximum_path

    def counted(value, mask):
        mas.count_launch()
        return real_path(value, mask)
    monkeypatch.setattr(matcha, "maximum_path", counted)
    monkeypatch.setattr(mas, "launches", 0)
    real = EvalGraphs.capture_graph

    def capture_graph(self, warm, body, keep_graph=False):
        out = real(self, warm, body, keep_graph)

        def replay():
            counted = mas.launches
            for t, v in zip(out[2].values(), body().values()):
                t.copy_(v)
            mas.launches = counted  # a replay's launch is counted by the graphs' owner, as on the card
        out[0].on_replay = replay
        return out
    monkeypatch.setattr(EvalGraphs, "capture_graph", capture_graph)
    state = _state()
    graphs = graphs_for(state.model)
    graphs.capture = True  # what a CUDA device gives, with the stubs above for the card
    return state, graphs


def test_stub_graphs_capture_once_per_key_and_count_k2_once_a_replay(stub_card):
    """Under the stub each key is captured once after its first (eager)
    call; K2 counts one launch a call whether it ran eagerly or replayed
    (the capture's count is taken back out); each call's outputs are its
    own, not the graph's memory, which the next replay rewrites."""
    state, graphs = stub_card
    model = state.model
    train, evals = _batches(), _batches(base=300)
    held = []
    for i, (tb, vb) in enumerate(zip(train, evals), 1):
        train_step(state, tb, SEED, graphs=False)
        before = mas.launches
        got = eval_step(model, vb, graphs=True)
        assert mas.launches == before + 1
        _equal(got, eval_step(model, vb, graphs=False))
        held.append((got, {k: v.clone() for k, v in got.items()}))
    for got, copy_ in held:
        _equal(got, copy_)
    entries = graphs.entries()
    assert graphs.captures == 2 and all(e.k2 == 1 for e in entries.values())
    assert graphs.stats()["replays"] == len(ORDER) - 2
    assert all(got["loss"].data_ptr() != e.out["loss"].data_ptr() for got, _ in held for e in entries.values())


def test_stub_graphs_align_and_probe_count_k2_once_a_call(stub_card):
    """``get_durations``' forward and the probe under the stub: one capture
    each per key, one K2 launch a call, replays equal to the eager body."""
    state, graphs = stub_card
    model = state.model
    batch = _batches(order=(0,), base=700)[0]
    z = torch.randn(batch["y"].shape, generator=step_generator(1, 0, "gen_mels", "cpu"))
    for i in range(3):
        before = mas.launches
        got = graphs.align(batch, z, n_timesteps=2)
        probe = graphs.probe(batch, z, n_timesteps=2)
        assert mas.launches == before + 2
        model.eval()
        attn, mu_x, x_mask, spk_e = model.align(batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"],
                                                batch["spks"])
        mel = model.decode_mel(mu_x, attn.sum(-1)[..., None], batch["y_lengths"], x_mask, spk_e, batch["y"].shape[1],
                               2, z)["mel"]
        want = model.training_probe(batch["x"], batch["x_lengths"], batch["y"], batch["y_lengths"], batch["spks"], 2,
                                    z=z)
        model.train()
        _equal(got, {"durations": attn.sum(-1), "mel": mel})
        _equal(probe, want)
        train_step(state, _batches(order=(1,), base=800 + i)[0], SEED, graphs=False)
    assert graphs.captures == 2 and graphs.stats()["replays"] == 4
