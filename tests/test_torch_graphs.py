"""Serving through the graph store (``inference/graphs.py``) on the CPU, at
the tiny config of ``tests/test_torch_denoiser_pipeline.py``'s ``pipes``.

On the CPU the store captures nothing: ``SynthesisPipeline(graphs=True,
device="cpu")`` runs the graph path's staging (keys, static buffers, runtime
values copied in, invalidation) with each stage run on its buffers.  What a
capture adds on the card, and a replay equal to the eager call there, is the
smoke's ``[graphs]`` phase; here a stub graph stands in for the card to show
K1's launch count under replay.

Tolerances: against the JAX pipeline those of
``test_whole_slice_matches_jax_chain`` (mel lengths equal, the float wav
within 1e-4, pcm16 within one step); against the port's eager path
(``graphs=False``) equal to the bit, since both run the same ops on the same
values (a 0-d tensor scalar and a Python float round alike).
"""

import contextlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu.inference.pipeline import SynthesisPipeline as JaxPipeline
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch.inference import graphs as graphs_mod
from emojivoice_tpu_torch.inference import pipeline as pipeline_mod
from emojivoice_tpu_torch.inference.graphs import GraphStore
from emojivoice_tpu_torch.inference.serving import BatchingEngine
from emojivoice_tpu_torch.inference.streaming import stream_synthesise
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax
from emojivoice_tpu_torch.ops import mrf
from tests.test_torch_denoiser_pipeline import MEL_BUCKETS, TEXT_BUCKETS, tiny_root

torch.set_num_threads(2)

STEPS, TEMP = 2, 0.667
TEXTS = ["hello there", "a longer sentence here"]


@pytest.fixture(scope="module")
def pipes():
    """The JAX pipeline's weights, and the port's pipeline on them twice:
    through the graph store and eagerly."""
    root = tiny_root()
    model = FlaxMatcha(cfg=root.model)
    init = jax.jit(lambda rng: model.init(
        {"params": rng}, jnp.ones((1, 8), jnp.int32), jnp.array([8]), 16, 1, 1.0, jnp.array([0]), 1.0, None,
        jnp.zeros((1, 16, 12)), method=FlaxMatcha.synthesise))
    params = jax.device_get(init(jax.random.PRNGKey(0)))
    voc_params = jax.device_get(jax.jit(FlaxHiFiGAN(cfg=root.vocoder).init)(jax.random.PRNGKey(1),
                                                                           jnp.zeros((1, 8, 12))))
    sds = (matcha_state_dict_from_flax(params, root.model), hifigan_state_dict_from_flax(voc_params, root.vocoder))

    def port(**kw):
        return pipeline_mod.SynthesisPipeline.from_state_dicts(
            root.model, sds[0], root.vocoder, sds[1], cleaners=("basic_cleaners",), mel_buckets=MEL_BUCKETS,
            text_buckets=TEXT_BUCKETS, device="cpu", **kw)

    return dict(root=root, params=params, voc_params=voc_params, port=port, graphs=port(graphs=True),
                eager=port(graphs=False))


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.mel_length == w.mel_length
        np.testing.assert_array_equal(g.wav, w.wav)
        np.testing.assert_array_equal(g.mel, w.mel)
        assert set(g.stage_ms) == set(w.stage_ms)


@pytest.mark.parametrize("fused", [False, True], ids=["two_stage", "fused"])
def test_graph_path_matches_jax_pipeline(pipes, monkeypatch, fused):
    """The JAX pipeline and the port's graph path on the same texts, speakers
    and injected noise: the port's ``synthesis_noise`` and the JAX pipeline's
    ``_row_noise`` both give the same draw."""
    z = (np.random.default_rng(3).normal(size=(2, MEL_BUCKETS[-1], 12)) * TEMP).astype(np.float32)
    monkeypatch.setattr(pipeline_mod, "synthesis_noise",
                        lambda seed, b, m_bucket, n_feats, temperature, device: torch.from_numpy(z[:b, :m_bucket]))
    root = pipes["root"]
    jp = JaxPipeline(root.model, pipes["params"], root.vocoder, pipes["voc_params"], cleaners=("basic_cleaners",),
                     mel_buckets=MEL_BUCKETS, text_buckets=TEXT_BUCKETS)
    monkeypatch.setattr(jp, "_row_noise", lambda rng, temperature, m_bucket: (None, jnp.asarray(z[:2, :m_bucket])))
    kw = dict(spks=[1, 3], n_timesteps=STEPS, temperature=TEMP, seed=0, fused=fused,
              fused_mel_bucket=128 if fused else None)
    ref = jp.synthesise(TEXTS, **kw)
    got = pipes["graphs"].synthesise(TEXTS, **kw)
    pcm = pipes["graphs"].synthesise(TEXTS, pcm16=True, **kw)
    for g, p, r in zip(got, pcm, ref):
        assert g.mel_length == p.mel_length == r.mel_length
        assert g.wav.shape == p.wav.shape == r.wav.shape == (g.mel_length * 16,)
        np.testing.assert_allclose(g.wav, r.wav, atol=1e-4)
        # the JAX pipeline's on-device cast (clip, scale, truncate) of its float wav
        ref_pcm = (np.clip(r.wav, -1.0, 1.0) * 32767.0).astype(np.int16).astype(np.int32)
        assert np.abs(np.round(p.wav * 32767).astype(np.int32) - ref_pcm).max() <= 1
    assert any(k[0] == "decoder" for k in pipes["graphs"].graphs.keys())


@pytest.mark.parametrize("fused", [False, True], ids=["two_stage", "fused"])
@pytest.mark.parametrize("dtype", ["f32", "compute_bf16"])
def test_graph_path_equals_eager_to_the_bit(pipes, fused, dtype):
    kw = dict(spks=[1, 3], n_timesteps=STEPS, seed=[4, 5], fused=fused, fused_mel_bucket=128 if fused else None)
    if dtype == "f32":
        g, e = pipes["graphs"], pipes["eager"]
    else:
        g, e = pipes["port"](graphs=True, compute_dtype=torch.bfloat16), \
            pipes["port"](graphs=False, compute_dtype=torch.bfloat16)
    for extra in (dict(pcm16=True, keep_mel=False), dict(denoiser_strength=0.0), dict(vocode=False)):
        _same(g.synthesise(TEXTS, **kw, **extra), e.synthesise(TEXTS, **kw, **extra))


def test_runtime_values_are_not_baked_into_a_key(pipes):
    """The trap witness: two calls on one key with another length_scale,
    temperature, denoiser strength, speakers, seeds and texts (of the same
    text bucket) each equal the eager call with the same arguments.  A graph
    that had baked the first call's values in would give the second the
    first's durations and denoising."""
    g, e = pipes["graphs"], pipes["eager"]
    calls = [dict(texts=["hello there"], spks=[1], seed=1, length_scale=1.0, temperature=0.667,
                  denoiser_strength=0.00025),
             dict(texts=["robots sing a song"], spks=[3], seed=2, length_scale=0.8, temperature=0.3,
                  denoiser_strength=0.05)]
    outs = []
    for fused in (True, False):
        held = None
        for c in calls:
            kw = dict(c, n_timesteps=STEPS, fused=fused, fused_mel_bucket=128 if fused else None)
            got = g.synthesise(kw.pop("texts"), **kw)
            _same(got, e.synthesise(c["texts"], **kw))
            outs.append(got[0])
            if fused:  # fused, the keys do not depend on the values: the second call reuses the first's graphs
                keys = set(g.graphs.entries())
                assert held is None or keys == held
                held = keys
    assert outs[0].mel_length != outs[1].mel_length  # length_scale 0.8 shortened the second


FIELDS = {  # a program-changing field of the JAX keys (pipeline.py:268, :281, :315) → the stages it re-keys
    "t_bucket": (dict(texts=["word " * 8]), {"encoder", "decoder"}),
    "batch": (dict(texts=TEXTS[:1] * 2, spks=[1, 1]), {"encoder", "decoder", "vocoder", "denoiser"}),
    "m_bucket": (dict(fused_mel_bucket=256), {"decoder", "vocoder", "denoiser"}),
    "n_timesteps": (dict(n_timesteps=3), {"decoder"}),
    "denoise": (dict(denoiser_strength=0.0), {"denoiser"}),
    "pcm16": (dict(pcm16=False), {"denoiser"}),
    "keep_mel": (dict(keep_mel=False), set()),  # picks the outputs copied out: no program here
    "vocode": (dict(vocode=False), set()),  # the vocoder's graphs do not run
}


@pytest.mark.parametrize("field", sorted(FIELDS))
def test_stage_keys_carry_the_jax_key_fields(pipes, field):
    """Each field of the JAX keys that changes a program here re-keys the
    stages it reaches, and only those; keep_mel and vocode change none."""
    pipe = pipes["port"](graphs=True)
    base = dict(texts=TEXTS[:1], spks=[1], n_timesteps=STEPS, seed=0, fused=True, fused_mel_bucket=128, pcm16=True)
    pipe.synthesise(**base)
    before = set(pipe.graphs.keys())
    change, stages = FIELDS[field]
    pipe.synthesise(**{**base, **change})
    new = set(pipe.graphs.keys()) - before
    assert {k[0] for k in new} == stages, new


def test_keys_name_the_jax_fields(pipes):
    """The keys' fields, as the pipeline builds them: the encoder's (text
    bucket, batch, speakers, dtype), the decoder's (text bucket, mel bucket,
    batch, steps, dtype), the vocoder's (batch, frames, K1's mode) and the
    denoiser's (batch, samples, denoise, pcm16)."""
    pipe = pipes["port"](graphs=True)
    pipe.synthesise(TEXTS[:1], spks=[2], n_timesteps=STEPS, seed=0, fused=True, fused_mel_bucket=128, pcm16=True)
    keys = {k[0]: k[1:] for k in pipe.graphs.keys()}
    assert keys == {"encoder": (64, 1, True, torch.float32), "decoder": (64, 128, 1, STEPS, torch.float32),
                    "vocoder": (1, 128, torch.float32), "denoiser": (1, 128 * 16, True, True)}


def test_warmup_holds_its_keys_and_default_is_eager_on_the_cpu(pipes):
    assert pipes["port"]().graphs is None  # the CPU's default: the eager path
    pipe = pipes["port"](graphs=True)
    pipe.warmup(n_timesteps=STEPS, batch=2, pcm16=True)
    batch_at = {"encoder": 2, "decoder": 3, "vocoder": 1, "denoiser": 1}
    assert {k[0] for k in pipe.graphs.keys()} == set(batch_at)
    assert all(k[batch_at[k[0]]] == 2 for k in pipe.graphs.keys())
    with BatchingEngine(pipe, max_batch=2, max_wait_ms=50, batch_buckets=(1, 2), pcm16=False) as eng:
        eng.warmup(n_timesteps=STEPS)
        held = set(pipe.graphs.entries())
        futs = [eng.submit("a " * 10, spk=1, seed=s, n_timesteps=STEPS) for s in (7, 8)]
        rows = [f.result(timeout=60) for f in futs]
    direct = pipes["eager"].synthesise(["a " * 10] * 2, spks=[1, 1], n_timesteps=STEPS, seed=[7, 8], keep_mel=False)
    for r, d in zip(rows, direct):  # per-row seeds: a row of batch 1 or 2 within test_per_row_seed_contract's bound
        np.testing.assert_allclose(r.wav, d.wav, atol=1e-5)
    assert set(pipe.graphs.entries()) == held  # the warmed keys served the requests


def test_new_weights_drop_the_graphs(pipes):
    """Weights written into a live pipeline, in place and as new objects,
    drop its graphs (on the card a graph reads the memory its weights had at
    capture); the next call equals the eager path on the new weights."""
    g, e = pipes["port"](graphs=True), pipes["port"](graphs=False)
    kw = dict(spks=[1], n_timesteps=STEPS, seed=0)

    def call():
        _same(g.synthesise(TEXTS[:1], **kw), e.synthesise(TEXTS[:1], **kw))

    def new_weights(write):
        with torch.no_grad():
            for p in (g, e):
                write(p)
        drops = g.graphs.drops
        call()
        assert g.graphs.drops == drops + 1
        call()  # the graphs the drop took, made again on the new weights
        assert g.graphs.drops == drops + 1
        assert {k[0] for k in g.graphs.keys()} == {"encoder", "decoder", "vocoder", "denoiser"}

    call()
    assert g.graphs.drops == 0
    # a res-block weight in place: K1's packed operands are made anew
    new_weights(lambda p: p.vocoder.resblocks[0].convs1[0].weight.mul_(1.5))
    sd = {k: v * 1.01 for k, v in g.model.state_dict().items()}
    new_weights(lambda p: p.model.load_state_dict(sd))  # a checkpoint loaded into the acoustic model
    # parameters replaced by new objects
    new_weights(lambda p: p.model.load_state_dict({k: v.clone() * 0.99 for k, v in sd.items()}, assign=True))


def test_streaming_and_concurrent_callers_go_through_the_store(pipes):
    """Streaming windows replay the vocoder's keys (batch 1, window frames);
    eight threads on one key each get their own call's result."""
    g, e = pipes["graphs"], pipes["eager"]
    kw = dict(spk=1, n_timesteps=STEPS, seed=3, chunk_frames=32, overlap=8)
    got = list(stream_synthesise(g, "a longer sentence to stream in windows", **kw))
    want = list(stream_synthesise(e, "a longer sentence to stream in windows", **kw))
    assert len(got) == len(want) > 1
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert {k for k in g.graphs.keys() if k[0] == "vocoder" and k[2] in (40, 48)}

    results = {}

    def call(i):
        results[i] = g.synthesise(["hello there"], spks=[i % 4], n_timesteps=STEPS, seed=i, length_scale=1 + i / 10)

    threads = [threading.Thread(target=call, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for i in range(8):
        _same(results[i], e.synthesise(["hello there"], spks=[i % 4], n_timesteps=STEPS, seed=i,
                                       length_scale=1 + i / 10))


def test_graphs_with_a_mesh_raise(pipes):
    """A mesh serves eagerly in this port: asking for graphs with one is refused
    before the mesh is used (any object stands for it here)."""
    with pytest.raises(ValueError, match="mesh"):
        pipes["port"](graphs=True, mesh=object())


class _StubGraph:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: the capture runs the
    stage once (its outputs become the static ones); a replay runs nothing."""

    replays = 0

    def __init__(self, keep_graph=False):
        pass

    def replay(self):
        _StubGraph.replays += 1

    def instantiate(self):
        pass


class _StubStream:
    def wait_stream(self, other):
        pass


def test_replays_count_k1_launches(monkeypatch):
    """K1's counter under replay: the wrapper counts while a graph is
    captured, not when it replays, so the store takes the build's counts
    (warm run and capture) back out and adds the capture's count on every
    replay: one launch per stage per call, first call included."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _StubGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda graph, pool=None, capture_error_mode="global":
                        contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _StubStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    store = GraphStore("cpu")
    store.capture = True  # what a CUDA device gives, with the stubs above for the card
    calls = []

    def vocoder(mel):  # four MRF stages, each one K1 launch, as the wrapper counts them
        calls.append(1)
        for c in (256, 128, 64, 32):
            mrf.count_launch(c, "f32")
        return mel * 2

    monkeypatch.setattr(mrf, "launches", mrf.launches.__class__())
    mel = torch.ones(1, 8, 4)
    for n in (1, 2, 3):
        out, = store.run(("vocoder", 1, 8, torch.float32), vocoder, (mel * n,))
        assert sum(mrf.launches.values()) == 4 * n and all(v == n for v in mrf.launches.values())
    assert len(calls) == 2 and _StubGraph.replays >= 3  # the warm run and the capture; replays ran nothing
    torch.testing.assert_close(out, mel * 2)  # the capture's outputs, copied out (the stub replays nothing)
    assert sum(store.build_launches.values()) == 4 and store.captures == 1
    with mrf.tally() as mine:
        mrf.count_launch(32, "bf16")
    assert mine == {(32, "bf16"): 1} and mrf.launches[(32, "bf16")] == 1
    assert graphs_mod.weights_stamp([mel]) == ((mel.data_ptr(), mel._version),)
