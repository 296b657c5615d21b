"""The train step through ``training/graphs.py`` on the CPU, at the ``tiny``
preset.

On the CPU ``TrainGraphs`` captures nothing: ``train_step(graphs=True)`` runs
the graph path's staging (bucket keys, static inputs, draws written into
static buffers, the learning rate filled in place, dropout seeded outside the
step, invalidation on a load) with the step's body run on the buffers.  What a
capture adds on the card, a replay equal to the eager step there, is the
smoke's ``[train_graphs]`` phase; here a stub graph stands in for the card to
show K2's count under replay and the copy-out of the metrics.

Tolerances: against the port's eager step equal to the bit (the same ops on
the same values, dropout on); against the JAX step those of
``tests/test_torch_training.py::test_three_optimizer_steps_match_jax``
(metrics rtol 1e-3, parameters atol 3e-4: Adam moves an element by about lr
a step whatever its gradient, so an element whose tiny gradient rounds
differently can differ by up to lr per step), dropout off, the port's draws
injected into the JAX step: ``make_train_step`` draws its own with threefry
inside the step, whose bits PyTorch cannot reproduce.
"""

import contextlib
import copy
import dataclasses
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.training import state as jax_state
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.io.from_jax import _load_adam, matcha_state_dict_from_flax
from emojivoice_tpu_torch.models import matcha
from emojivoice_tpu_torch.ops import mas
from emojivoice_tpu_torch.training import state as port_state
from emojivoice_tpu_torch.training.graphs import TrainGraphs
from emojivoice_tpu_torch.training.state import batch_to_device, create_train_state, train_step
from emojivoice_tpu_torch.utils.prng import training_draws
from emojivoice_tpu_torch.training.train import main as train_main
from tests.test_torch_train_cli import _args, _records, corpus  # noqa: F401  (corpus is a fixture)
from tests.test_torch_training import _jargs, _port, pair  # noqa: F401  (pair is a fixture)

torch.set_num_threads(2)

SEED = 7
OUT_SIZE = 16  # the crop applies at T_mel 32 and not at 16: the two keys differ in it too
KEYS = ((2, 12, 32), (3, 8, 16))  # (B, T_text, T_mel) of the two interleaved bucket keys
ORDER = (0, 1, 0, 1, 0)
METRICS = ("loss", "dur_loss", "prior_loss", "diff_loss", "grad_norm", "lr")


def _cfg(decoder="transformer", out_size=OUT_SIZE):
    cfg = cfglib.get_preset("tiny").model
    dec = dataclasses.replace(cfg.decoder, down_block_type=decoder, mid_block_type=decoder, up_block_type=decoder)
    return dataclasses.replace(cfg, decoder=dec, out_size=out_size)


def _np_batch(b, tx, ty, seed, n_feats=80, n_spks=4):
    rng = np.random.default_rng(seed)
    xl = np.concatenate([[tx], rng.integers(tx // 2, tx + 1, b - 1)]).astype(np.int32)
    yl = np.concatenate([[ty], rng.integers(ty // 2, ty + 1, b - 1)]).astype(np.int32)
    x = np.zeros((b, tx), np.int32)
    y = np.zeros((b, ty, n_feats), np.float32)
    for i in range(b):
        x[i, : xl[i]] = rng.integers(1, 170, xl[i])
        y[i, : yl[i]] = rng.normal(size=(yl[i], n_feats)).astype(np.float32)
    return {"x": x, "x_lengths": xl, "y": y, "y_lengths": yl, "spks": rng.integers(0, n_spks, b).astype(np.int32)}


def _batches():
    return [batch_to_device(_np_batch(*KEYS[k], seed=100 + i), "cpu") for i, k in enumerate(ORDER)]


def _state(cfg, opt_cfg=None):
    return create_train_state(cfg, opt_cfg or cfglib.OptimizerConfig(), seed=SEED, device="cpu")


def _run(state, batches, graphs):
    return [{k: v.clone() for k, v in train_step(state, b, SEED, graphs=graphs).items()} for b in batches]


def _assert_same_state(a, b):
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
        sa, sb = a.optimizer.state[p], b.optimizer.state[q]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), (name, k)
    for (name, x), y in zip(a.model.named_buffers(), b.model.buffers()):
        assert torch.equal(x, y), name
    assert a.step == b.step


def _assert_same_metrics(got, want):
    for i, (g, w) in enumerate(zip(got, want)):
        for k in METRICS:
            assert torch.equal(g[k], w[k]), (i, k, float(g[k]), float(w[k]))


@pytest.mark.parametrize("decoder", ["transformer", "conformer"])
def test_staged_steps_equal_eager_to_the_bit(decoder):
    """Two bucket keys interleaved, dropout on: metrics, parameters, Adam's
    moments and (conformer) the BatchNorm buffers equal the eager steps'."""
    cfg = _cfg(decoder)
    batches = _batches()
    staged, eager = _state(cfg), _state(cfg)
    got, want = _run(staged, batches, True), _run(eager, batches, False)
    _assert_same_metrics(got, want)
    _assert_same_state(staged, eager)
    keys = staged.graphs.keys()
    assert sorted(k[:3] for k in keys) == sorted(KEYS) and eager.graphs is None
    assert {k[:3]: k[4] for k in keys} == {KEYS[0]: True, KEYS[1]: False}  # the crop, in the key
    assert staged.graphs.stats()["replays"] == len(ORDER) - 2 and staged.graphs.captures == 0  # nothing captured
    if decoder == "conformer":
        moved = [n for n, x in staged.model.named_buffers() if "running_mean" in n and float(x.abs().sum()) > 0]
        assert moved  # the BatchNorm statistics were updated in the staged steps


def test_staged_steps_match_jax(pair):  # noqa: F811
    """Three staged f32 steps at one key (the first builds its buffers, the
    next two run on them) against the JAX step on the same weights, batches
    and draws, dropout off, a warm-up schedule and a clip that bites.  One
    shape: each new one costs the JAX step a compile."""
    model, params = pair
    cfg = cfglib.get_preset("tiny").model
    opt_cfg = dataclasses.replace(cfglib.OptimizerConfig(), scheduler="cosine", warmup_steps=1, decay_steps=10,
                                  grad_clip=0.5)
    jopt = jax_cfglib.OptimizerConfig(**dataclasses.asdict(opt_cfg))
    tx, sched = jax_state.make_optimizer(jopt), jax_state.make_schedule(jopt)

    @jax.jit
    def jstep(p, opt_state, args, t, z):
        def loss_fn(pp):
            dur, prior, diff, _ = model.apply(pp, *args, rng=jax.random.PRNGKey(0), deterministic=True, t=t, z=z)
            return dur + prior + diff, (dur, prior, diff)
        (total, (dur, prior, diff)), g = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, opt_state = tx.update(g["params"], opt_state, p["params"])
        return {"params": optax.apply_updates(p["params"], updates)}, opt_state, {
            "loss": total, "dur_loss": dur, "prior_loss": prior, "diff_loss": diff,
            "grad_norm": optax.global_norm(g["params"])}

    state = create_train_state(cfg, opt_cfg, model=_port(params), device="cpu")
    for m in state.model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0  # the prenet's fixed 0.5 included
    jp, jopt_state = params, tx.init(params["params"])
    b, tx_len, ty = 2, 16, 32
    for i in range(3):
        nb = _np_batch(b, tx_len, ty, seed=20 + i, n_feats=cfg.n_feats, n_spks=cfg.n_spks)
        draws = training_draws(SEED, state.step, b, ty, cfg.n_feats, "cpu")
        ours = train_step(state, batch_to_device(nb, "cpu"), SEED, graphs=True)
        jp, jopt_state, jm = jstep(jp, jopt_state, _jargs(nb), jnp.asarray(draws["t"].numpy()),
                                   jnp.asarray(draws["z"].numpy()))
        for k, v in jm.items():
            np.testing.assert_allclose(float(ours[k]), float(v), rtol=1e-3, err_msg=f"step {i} {k}")
        np.testing.assert_allclose(float(ours["lr"]), float(sched(i)), rtol=1e-6)
        assert float(jm["grad_norm"]) > opt_cfg.grad_clip
    assert len(state.graphs.keys()) == 1 and state.graphs.stats()["replays"] == 2
    theirs = matcha_state_dict_from_flax(jax.device_get(jp), cfg, buffers=False)
    start = matcha_state_dict_from_flax(params, cfg, buffers=False)
    moved = 0.0
    for name, p in state.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), theirs[name], atol=3e-4, rtol=0, err_msg=name)
        moved = max(moved, float(np.abs(theirs[name] - start[name]).max()))
    assert moved > 5e-5


def test_loads_drop_the_graphs_and_resume_exactly():
    """A checkpoint load, a sharded-format load and ``io/from_jax.py``'s Adam
    load each drop every graph; a resumed staged run repeats an unbroken one
    to the bit, and an eager run resumed from a staged checkpoint too."""
    cfg = _cfg()
    batches = _batches()
    whole = _state(cfg)
    want = _run(whole, batches, True)

    broken = _state(cfg)
    _run(broken, batches[:3], True)
    saved = copy.deepcopy(broken.state_dict())
    _run(broken, batches[3:], True)  # steps past the checkpoint, then back to it
    assert broken.graphs.keys()
    broken.load_state_dict(copy.deepcopy(saved))
    assert broken.graphs.keys() == [] and broken.graphs.drops == 1
    _assert_same_metrics(_run(broken, batches[3:], True), want[3:])
    _assert_same_state(broken, whole)

    eager = _state(cfg)
    eager.load_state_dict(copy.deepcopy(saved))
    _assert_same_metrics(_run(eager, batches[3:], False), want[3:])
    _assert_same_state(eager, whole)

    # the sharded format's load writes in place, and drops the graphs all the same
    opt = broken.optimizer
    sd = {"model": {k: v.clone() for k, v in broken.model.state_dict().items()},
          "optimizer": {n: {k: v.clone() for k, v in opt.state[p].items()} for n, p in broken.model.named_parameters()},
          "step": torch.tensor(broken.step)}
    assert broken.graphs.keys()
    broken.load_sharded_state_dict(sd)
    assert broken.graphs.keys() == [] and broken.graphs.drops == 2

    # Adam's state from the JAX package's moments replaces the optimizer's state
    _run(broken, batches[:1], True)
    named = list(broken.model.named_parameters())
    first = {n: opt.state[p]["exp_avg"].numpy().copy() for n, p in named}
    second = {n: opt.state[p]["exp_avg_sq"].numpy().copy() for n, p in named}
    _load_adam(opt, named, first, second, 3)
    assert broken.graphs.keys() == [] and broken.graphs.drops == 3
    assert isinstance(opt.param_groups[0]["lr"], float)  # the CPU's Adam keeps a float rate
    _run(broken, batches[:1], True)
    assert all(float(opt.state[p]["step"]) == 4 for _, p in named)


def test_a_replaced_parameter_drops_the_graphs():
    """``load_state_dict(assign=True)`` replaces the parameter objects: the
    graphs, which hold the old ones, are dropped at the next step."""
    state = _state(_cfg())
    batches = _batches()
    _run(state, batches[:2], True)
    state.model.load_state_dict(state.model.state_dict(), assign=True)
    _run(state, batches[2:3], True)
    assert state.graphs.drops == 1 and len(state.graphs.keys()) == 1


def test_mesh_and_clock_with_graphs_raise_and_the_cpu_default_is_eager():
    state = _state(_cfg())
    batch = _batches()[0]
    with pytest.raises(ValueError, match="clock"):
        train_step(state, batch, SEED, clock=object(), graphs=True)
    state.mesh = object()  # any object stands for a mesh: refused before it is used
    with pytest.raises(ValueError, match="mesh"):
        train_step(state, batch, SEED, graphs=True)
    with pytest.raises(ValueError, match="mesh"):
        TrainGraphs(state)
    state.mesh = None
    assert state.step == 0 and state.graphs is None
    train_step(state, batch, SEED)
    assert state.graphs is None and state.step == 1  # eager on the CPU unless asked


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: the capture runs the
    step once (its outputs become the static ones); a replay runs nothing
    but `on_replay`, which a test points at the static outputs."""

    def __init__(self, keep_graph=False):
        self.replays = 0
        self.on_replay = None

    def replay(self):
        self.replays += 1
        if self.on_replay is not None:
            self.on_replay()


class _StubStream:
    def wait_stream(self, other):
        pass


@pytest.fixture
def stub_card(monkeypatch):
    """The card's graph calls stubbed, and K2 counted on the CPU as the
    wrapper counts it on the card (one ``count_launch`` a search)."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, pool=None, capture_error_mode="global":
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    real = matcha.maximum_path

    def counted(value, mask):
        mas.count_launch()
        return real(value, mask)
    monkeypatch.setattr(matcha, "maximum_path", counted)
    monkeypatch.setattr(mas, "launches", 0)
    state = _state(_cfg())
    state.graphs = TrainGraphs(state)
    state.graphs.capture = True  # what a CUDA device gives, with the stubs above for the card
    return state


def test_replays_count_k2_launches(stub_card):
    """K2's counter under replay: the wrapper counts in the first step and
    while the graph is captured, never when it replays, so the capture's
    count is taken back out and each replay adds it: one launch a step.
    Each replay bumps the weights' autograd versions, which a capture-free
    write would not."""
    state = stub_card
    batches = _batches()
    for i, b in enumerate(batches, 1):
        versions = [p._version for p in state.model.parameters()]
        train_step(state, b, SEED, graphs=True)
        assert mas.launches == i
        assert all(p._version > v for p, v in zip(state.model.parameters(), versions))
    assert state.graphs.captures == 2 and state.graphs.stats()["replays"] == len(ORDER) - 2
    assert state.step == len(ORDER)
    with mas.tally() as mine:
        mas.count_launch()
    assert mine == [1] and mas.launches == len(ORDER) + 1


def test_a_metric_read_one_step_late_is_not_overwritten(stub_card):
    """The trainer reads a step's metrics after the next step: the outputs
    are copied out of the graph's memory at each replay, so the next replay
    (here: one that writes its static outputs) leaves them alone."""
    state = stub_card
    batch = _batches()[0]
    train_step(state, batch, SEED, graphs=True)  # the first step and the capture
    g, = state.graphs.entries().values()
    g.graph.on_replay = lambda: [v.add_(1.0) for v in g.out.values()]
    first = train_step(state, batch, SEED, graphs=True)
    held = {k: float(v) for k, v in first.items()}
    second = train_step(state, batch, SEED, graphs=True)
    assert {k: float(v) for k, v in first.items()} == held
    assert float(second["loss"]) == held["loss"] + 1.0  # the replay's own outputs, copied out
    assert all(first[k].data_ptr() != v.data_ptr() for k, v in g.out.items())


def test_a_capture_is_thread_local_with_the_cycle_collector_off(stub_card, monkeypatch):
    """Another thread's wait on the device, and a graph freed by the cycle
    collector, each end a capture in the default "global" error mode (seen
    on the card).  So every capture takes the "thread_local" mode with the
    collector off, and the collector is on again after it."""
    seen = []

    def graph(graph, pool=None, capture_error_mode="global"):
        seen.append((capture_error_mode, gc.isenabled()))
        return contextlib.nullcontext()
    monkeypatch.setattr(torch.cuda, "graph", graph)
    assert gc.isenabled()
    for b in _batches():
        train_step(stub_card, b, SEED, graphs=True)
    assert stub_card.graphs.captures == 2 and seen == [("thread_local", False)] * 2
    assert gc.isenabled()


def test_a_dropped_state_frees_its_graphs_at_once():
    """The graphs hold their state by a weak reference, so a dropped state
    frees its graphs (and on the card their pool) by reference count alone,
    not later through the cycle collector."""
    state = _state(_cfg())
    train_step(state, _batches()[0], SEED, graphs=True)
    graphs = weakref.ref(state.graphs)
    collecting = gc.isenabled()
    gc.disable()
    try:
        del state
        assert graphs() is None
    finally:
        if collecting:
            gc.enable()


def test_lr_is_a_device_tensor_filled_in_place():
    """The optimizer's rate form: a float on the CPU; ``set_lr_`` fills a
    tensor rate in place (the object a captured step holds) and a load
    brings a loaded rate back to the optimizer's form."""
    state = _state(_cfg())
    port_state.set_lr_(state.optimizer, 3e-4)
    assert state.optimizer.param_groups[0]["lr"] == 3e-4
    rate = torch.tensor(1e-4)
    state.optimizer.param_groups[0]["lr"] = rate
    port_state.set_lr_(state.optimizer, 2e-4)
    assert state.optimizer.param_groups[0]["lr"] is rate and float(rate) == pytest.approx(2e-4)
    state.optimizer.load_state_dict(state.optimizer.state_dict())
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(2e-4)
    assert isinstance(state.optimizer.param_groups[0]["lr"], float)


def _card_form(saved: dict) -> dict:
    """`saved` as a capturable optimizer on the card writes it, read back on
    the CPU: every group says ``capturable``, the rate is a 0-d tensor and
    the step counts are f32 tensors."""
    opt = copy.deepcopy(saved["optimizer"])
    for group in opt["param_groups"]:
        group.update(capturable=True, lr=torch.tensor(float(group["lr"])))
    for st in opt["state"].values():
        st["step"] = st["step"].to(torch.float32)
    return {**saved, "optimizer": opt}


def test_a_card_checkpoint_resumes_on_the_cpu():
    """``load_state_dict`` takes ``capturable`` from the file: a checkpoint of
    the card's capturable optimizer, loaded on the CPU, would leave a
    capturable Adam that the CPU refuses.  The load keeps the optimizer as it
    was made, and the resumed run repeats an unbroken one to the bit."""
    cfg = _cfg()
    batches = _batches()
    whole = _state(cfg)
    want = _run(whole, batches, False)
    broken = _state(cfg)
    _run(broken, batches[:3], False)
    saved = _card_form(broken.state_dict())
    resumed = _state(cfg)
    resumed.load_state_dict(saved)
    opt = resumed.optimizer
    assert all(g["capturable"] is False and isinstance(g["lr"], float) for g in opt.param_groups)
    assert all(st["step"].device.type == "cpu" for st in opt.state.values())
    _assert_same_metrics(_run(resumed, batches[3:], False), want[3:])
    _assert_same_state(resumed, whole)


def test_a_plain_checkpoint_loads_into_a_capturable_optimizer():
    """The other way: a plain Adam's checkpoint (written on the CPU, or
    before the card's optimizer was capturable) loaded into a
    capturable one stays capturable, with its rate a 0-d f32 tensor and f32
    step counts on the parameters' device, as a captured step reads them.
    (The CPU builds a capturable Adam but refuses its step: the step is the
    smoke's ``[train_graphs]`` (b).)"""
    state = _state(_cfg())
    _run(state, _batches()[:2], False)
    params = list(state.model.parameters())
    cap = port_state.make_optimizer(params, cfglib.OptimizerConfig(), capturable=True)
    cap.load_state_dict(copy.deepcopy(state.optimizer.state_dict()))
    group, = cap.param_groups
    assert group["capturable"] is True and torch.is_tensor(group["lr"]) and group["lr"].dtype == torch.float32
    assert float(group["lr"]) == pytest.approx(state.optimizer.param_groups[0]["lr"])
    for p in params:
        st, plain = cap.state[p], state.optimizer.state[p]
        assert st["step"].dtype == torch.float32 and st["step"].device == p.device and float(st["step"]) == 2
        assert torch.equal(st["exp_avg"], plain["exp_avg"]) and torch.equal(st["exp_avg_sq"], plain["exp_avg_sq"])


def test_trainer_census_records_the_graphs(corpus, tmp_path):  # noqa: F811
    """The trainer's ``shapes`` record says how the steps ran and carries the
    graphs' census (captures, capture ms per shape, pool bytes); on the CPU,
    eager by default and with ``--eager`` alike, nothing is captured."""
    for extra in ((), ("--eager",)):
        out = tmp_path / ("eager" if extra else "default")
        assert train_main(_args(corpus, out, "--fast_dev_run", *extra)) == 0
        shapes, = _records(out, "shapes")
        assert shapes["graphs"] is False and shapes["captures"] == 0 and shapes["pool_bytes"] is None
        assert [r["capture_ms"] for r in shapes["shapes"]] == [None] * shapes["distinct_shapes"]
