"""The port's dynamic-batching engine (``emojivoice_tpu_torch.inference.serving``).

The engine tests of ``tests/test_serving.py`` mirrored one for one on the
port's pipeline at the tiny config (``tests/test_pipeline.py::tiny_root``'s
sizes, weights carried over from a flax init through ``io/from_jax.py``,
``device="cpu"``), the fake-backend soak of ``tests/test_serving_stress.py``,
and the port's engine held against the JAX package's on one fake backend:
the same requests give the same dispatched batches and the same counters.

Tolerances: a seeded request inside a merged batch against the direct
batch-1 call with that seed within atol 1e-5 on the float waveform (the JAX
contract; batch shapes sum in other orders) and one pcm16 step on int16 audio
(the truncating cast flips by one where the floats differ in the last digits);
same-seed rows of one batch equal to the bit.  Every wait has a timeout.
"""

import random
import threading
import time
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emojivoice_tpu import config as jax_cfglib
from emojivoice_tpu.inference.serving import BatchingEngine as JaxBatchingEngine
from emojivoice_tpu.models import MatchaTTS as FlaxMatcha
from emojivoice_tpu.vocoder import HiFiGANGenerator as FlaxHiFiGAN
from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.inference.serving import BatchingEngine
from emojivoice_tpu_torch.io.from_jax import hifigan_state_dict_from_flax, matcha_state_dict_from_flax
from emojivoice_tpu_torch.utils import observability as obs
from emojivoice_tpu_torch.utils.buckets import pick_bucket
from emojivoice_tpu_torch.utils.masks import fix_len_compatibility
from tests.test_pipeline import tiny_root

torch.set_num_threads(2)

TIMEOUT = 120


def flax_tiny_params(seed: int = 0):
    """(JAX RootConfig, flax MatchaTTS params, flax HiFi-GAN params) at the tiny config."""
    root = tiny_root()
    n_feats = root.model.n_feats
    model = FlaxMatcha(cfg=root.model)
    # initialised through the inference path, jitted: the cheapest compile
    init = jax.jit(lambda rng: model.init(
        {"params": rng}, jnp.ones((1, 8), jnp.int32), jnp.array([8]), 16, 1, 1.0, jnp.array([0]), 1.0, None,
        jnp.zeros((1, 16, n_feats)), method=FlaxMatcha.synthesise))
    params = jax.device_get(init(jax.random.PRNGKey(seed)))
    voc_init = jax.jit(lambda rng: FlaxHiFiGAN(cfg=root.vocoder).init(rng, jnp.zeros((1, 8, n_feats))))
    voc_params = jax.device_get(voc_init(jax.random.PRNGKey(seed + 1)))
    return root, params, voc_params


def port_root(jax_root) -> cfglib.RootConfig:
    """The port's RootConfig with the JAX config's values."""
    return cfglib.from_dict(cfglib.RootConfig, jax_cfglib.to_dict(jax_root))


def bridged_pipeline(seed: int = 0, **kw) -> SynthesisPipeline:
    """The port's CPU pipeline on a flax init's weights."""
    jax_root, params, voc_params = flax_tiny_params(seed)
    root = port_root(jax_root)
    kw.setdefault("cleaners", ("basic_cleaners",))
    return SynthesisPipeline.from_state_dicts(
        root.model, matcha_state_dict_from_flax(params, root.model), root.vocoder,
        hifigan_state_dict_from_flax(voc_params, root.vocoder), device="cpu", **kw)


@pytest.fixture(scope="module")
def pipe():
    return bridged_pipeline(mel_buckets=(64, 128), text_buckets=(64,))


def test_concurrent_requests_merge_into_one_batch(pipe):
    with BatchingEngine(pipe, max_batch=4, max_wait_ms=2000, batch_buckets=(1, 2, 4)) as eng:
        futs = [eng.submit(f"hello number {i}", spk=i, n_timesteps=2) for i in range(4)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
        for r in results:
            assert r.mel_length > 0 and np.isfinite(r.wav).all()
            assert r.mel.size == 0  # audio only unless the request asks for the mel
        s = eng.stats()
    assert s["batches"] == 1, s
    assert s["batched_rows"] == 4
    assert s["batch_hist"] == {4: 1}
    assert s["pad_rows"] == 0
    assert 0 <= s["wait_ms_p50"] <= s["wait_ms_p95"] <= 1e3 * TIMEOUT
    n = min(results[0].wav.size, results[1].wav.size)
    assert not np.allclose(results[0].wav[:n], results[1].wav[:n])  # other speakers, other audio


def test_batch_padded_to_bucket(pipe):
    with BatchingEngine(pipe, max_batch=4, max_wait_ms=1500, batch_buckets=(1, 2, 4)) as eng:
        futs = [eng.submit("pad me", n_timesteps=2) for _ in range(3)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        s = eng.stats()
    assert s["batch_hist"] == {4: 1}  # 3 rows → bucket 4
    assert s["pad_rows"] == 1


def test_pad_rows_get_no_vocoder_work_and_are_counted(pipe):
    """Three requests in batch bucket 4: the engine tells the pipeline that
    three rows are live, so the pad row gets reach 0 and no result, each live
    row's audio equals the same padded batch called directly to the bit, and
    the counters hold the row-frames K1 computes (each live row's length and
    the widest stage margin, at most the mel bucket) and those of the padded
    call."""
    texts = ["pad me", "pad me too, a little longer", "and me"]
    with BatchingEngine(pipe, max_batch=4, max_wait_ms=1500, batch_buckets=(1, 2, 4), pcm16=False) as eng:
        futs = [eng.submit(t, spk=i, n_timesteps=2, seed=20 + i) for i, t in enumerate(texts)]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        s = eng.stats()
    assert s["batches"] == 1 and s["pad_rows"] == 1
    direct = pipe.synthesise(texts + texts[-1:], spks=[0, 1, 2, 2], n_timesteps=2, seed=[20, 21, 22, 22])
    for g, d in zip(got, direct):
        assert np.array_equal(g.wav, d.wav) and np.isfinite(g.wav).all()
    m_bucket = pick_bucket(fix_len_compatibility(max(r.mel_length for r in got)), pipe.mel_buckets)
    assert s["k1_frames_all_sum"] == 4 * m_bucket
    assert s["k1_frames_live_sum"] == sum(min(r.mel_length + pipe.k1_margin, m_bucket) for r in got)


def test_mismatched_program_keys_split_batches(pipe):
    """Requests with different ODE-step counts cannot share a call."""
    with BatchingEngine(pipe, max_batch=2, max_wait_ms=800, batch_buckets=(1, 2)) as eng:
        fa = eng.submit("first", n_timesteps=2)
        fb = eng.submit("second", n_timesteps=3)
        fc = eng.submit("third", n_timesteps=2)
        for f in (fa, fb, fc):
            assert f.result(timeout=TIMEOUT).mel_length > 0
        s = eng.stats()
    assert s["batches"] == 2
    assert s["batched_rows"] == 3


def test_pipelined_batches_resolve_correctly(pipe):
    """Sustained load drives the worker's depth-1 pipeline: every future
    resolves, and results stay matched to their request."""
    texts = [f"stream item {i}" for i in range(10)]
    with BatchingEngine(pipe, max_batch=2, max_wait_ms=5, batch_buckets=(1, 2)) as eng:
        futs = [eng.submit(t, spk=i % 3, n_timesteps=2, seed=100 + i) for i, t in enumerate(texts)]
        results = [f.result(timeout=TIMEOUT) for f in futs]
        s = eng.stats()
    assert s["batches"] >= 5 and s["batched_rows"] == 10
    for i, r in enumerate(results):
        assert r.mel_length > 0 and np.isfinite(r.wav).all()
        assert r.cleaned_text == texts[i].lower()
    direct = pipe.synthesise([texts[4]], spks=[4 % 3], n_timesteps=2, seed=104, pcm16=True)[0]
    assert direct.mel_length == results[4].mel_length
    np.testing.assert_allclose(direct.wav, results[4].wav, atol=1.01 / 32767)  # one pcm16 step


def test_bad_language_rejected_at_submit(pipe):
    with BatchingEngine(pipe, max_batch=2, max_wait_ms=100) as eng:
        with pytest.raises(KeyError):
            eng.submit("boom", language="klingon", n_timesteps=2)
        assert eng.submit("still alive", n_timesteps=2).result(timeout=TIMEOUT).mel_length > 0


def test_poison_row_isolated_from_batch(pipe):
    """A request that fails at dispatch (text exceeds every bucket) fails
    alone: the engine re-dispatches its batch as singletons."""
    too_long = "word " * 200  # the largest text bucket is 64
    with BatchingEngine(pipe, max_batch=3, max_wait_ms=2000, batch_buckets=(1, 2, 4)) as eng:
        good1 = eng.submit("short one", n_timesteps=2)
        bad = eng.submit(too_long, n_timesteps=2)
        good2 = eng.submit("short two", n_timesteps=2)
        assert good1.result(timeout=TIMEOUT).mel_length > 0
        assert good2.result(timeout=TIMEOUT).mel_length > 0
        with pytest.raises(ValueError):
            bad.result(timeout=TIMEOUT)
        s = eng.stats()
    assert s["errors"] == 1 and s["failed_batches"] >= 1


def test_batch_buckets_derived_from_max_batch(pipe):
    eng = BatchingEngine(pipe, max_batch=16, max_wait_ms=1)
    assert eng.batch_buckets == (1, 2, 4, 8, 16)
    eng.close()
    with pytest.raises(ValueError):
        BatchingEngine(pipe, max_batch=8, batch_buckets=(1, 2))


def test_close_rejects_new_and_drains(pipe):
    eng = BatchingEngine(pipe, max_batch=1, max_wait_ms=1, batch_buckets=(1,))
    fut = eng.submit("last words", n_timesteps=2)
    eng.close()
    assert fut.result(timeout=TIMEOUT).mel_length > 0
    with pytest.raises(RuntimeError):
        eng.submit("too late")
    eng.close()  # idempotent


def test_close_resolves_in_flight_pipelined_batch(pipe):
    eng = BatchingEngine(pipe, max_batch=1, max_wait_ms=1, batch_buckets=(1,))
    futs = [eng.submit(f"burst {i}", n_timesteps=2, seed=i) for i in range(5)]
    eng.close(timeout=TIMEOUT)
    for f in futs:
        assert f.result(timeout=TIMEOUT).mel_length > 0


def test_per_request_seed_reproduces_direct_call(pipe):
    text = "seeded request text"
    with BatchingEngine(pipe, max_batch=4, max_wait_ms=2000, batch_buckets=(1, 2, 4), pcm16=False) as eng:
        futs = [eng.submit(text, spk=1, n_timesteps=2, seed=s) for s in (11, 12, 11)]
        merged = [f.result(timeout=TIMEOUT) for f in futs]
        assert eng.stats()["batches"] == 1  # genuinely co-batched
    direct = pipe.synthesise([text], spks=[1], n_timesteps=2, seed=11)[0]
    np.testing.assert_allclose(merged[0].wav, direct.wav, atol=1e-5)
    np.testing.assert_array_equal(merged[2].wav, merged[0].wav)
    assert float(np.abs(merged[1].wav - merged[0].wav).max()) > 1e-3


def test_cancelled_future_does_not_kill_worker(pipe):
    with BatchingEngine(pipe, max_batch=1, max_wait_ms=1, batch_buckets=(1,)) as eng:
        fut = eng.submit("cancel me", n_timesteps=2)
        fut.cancel()  # may race the dispatch; either way the worker survives
        later = eng.submit("worker still alive", n_timesteps=2)
        assert later.result(timeout=TIMEOUT).mel_length > 0


def test_blocking_wrapper(pipe):
    with BatchingEngine(pipe, max_batch=1, max_wait_ms=1, batch_buckets=(1,)) as eng:
        res = eng.synthesise("one shot", n_timesteps=2, keep_mel=True)
    assert res.mel_length > 0 and res.mel.shape == (res.mel_length, 12)


def test_wait_window_respected(pipe):
    """A lone request dispatches after ~max_wait_ms, not after max_batch."""
    with BatchingEngine(pipe, max_batch=8, max_wait_ms=50, batch_buckets=(1, 2, 4, 8)) as eng:
        t0 = time.monotonic()
        res = eng.submit("alone", n_timesteps=2).result(timeout=TIMEOUT)
        assert res.mel_length > 0 and time.monotonic() - t0 >= 0.05
        s = eng.stats()
    assert s["batch_hist"] == {1: 1}


def test_warmup_runs_every_batch_bucket(pipe):
    seen = []
    real = pipe.synthesise_async

    def spy(texts, **kw):
        seen.append((len(texts), kw["keep_mel"], kw["pcm16"], kw["n_timesteps"]))
        return real(texts, **kw)

    pipe.synthesise_async = spy
    try:
        with BatchingEngine(pipe, max_batch=4, max_wait_ms=1) as eng:
            eng.warmup(n_timesteps=2)
    finally:
        del pipe.synthesise_async
    assert seen == [(1, False, True, 2), (2, False, True, 2), (4, False, True, 2)]


# ---------------------------------------------------------------------------
# host-only fake backend: the engine's own threading
# ---------------------------------------------------------------------------

class _FakeBackend:
    """Minimal synthesise_async/finalize backend: echoes texts back after a
    tiny simulated fetch; a batch containing a 'poison' text fails at
    dispatch, and the engine must isolate the bad row."""

    n_timesteps = 10
    denoiser_strength = 0.00025

    def __init__(self):
        self.calls = []
        self._lock = threading.Lock()

    def synthesise_async(self, texts, spks=None, seed=None, **kw):
        with self._lock:
            self.calls.append((tuple(texts), tuple(spks), tuple(seed), tuple(sorted(kw.items()))))
        if any("poison" in t for t in texts):
            raise ValueError("poison text")
        return list(texts)

    def finalize(self, pending):
        time.sleep(0.0002)  # simulated device→host drain
        return [SimpleNamespace(text=t) for t in pending]


@pytest.mark.parametrize("seed", [0, 1])
def test_engine_soak_cancels_poison_and_close_race(seed):
    """Clients × cancels × poison rows × a close racing the submits: every
    submitted future is done once close() returns, a cancel never kills the
    worker, a poison row fails alone, and a submit racing close() either
    resolves or raises RuntimeError."""
    rng = random.Random(seed)
    eng = BatchingEngine(_FakeBackend(), max_batch=8, max_wait_ms=2)
    futures, flock = [], threading.Lock()
    n_clients, per_client = 6, 150
    start = threading.Barrier(n_clients + 1)
    closed_at = threading.Event()

    def client(k):
        r = random.Random(seed * 7919 + k)
        start.wait(timeout=30)
        for i in range(per_client):
            text = f"poison {k}-{i}" if r.random() < 0.05 else f"utt {k}-{i}"
            try:
                fut = eng.submit(text, spk=k, seed=k * 1000 + i)
            except RuntimeError:
                assert closed_at.is_set()  # the only allowed refusal, once close() has begun
                continue
            cancelled = r.random() < 0.10 and fut.cancel()
            with flock:
                futures.append((fut, text, cancelled))
            if r.random() < 0.02:
                time.sleep(0.001)

    threads = [threading.Thread(target=client, args=(k,)) for k in range(n_clients)]
    for t in threads:
        t.start()
    start.wait(timeout=30)
    stop_stats = threading.Event()

    def stats_poller():  # stats() takes the lock the worker uses
        while not stop_stats.is_set():
            s = eng.stats()
            assert s["batched_rows"] <= s["requests"]
            time.sleep(0.001)

    poller = threading.Thread(target=stats_poller)
    poller.start()
    time.sleep(0.05 + rng.random() * 0.1)
    closed_at.set()
    eng.close(timeout=60)
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    stop_stats.set()
    poller.join(10)

    assert not eng._worker.is_alive() and not eng._finalizer.is_alive(), "both threads must exit after close()"
    assert futures, "soak submitted nothing before close"
    n_ok = n_poison = 0
    for fut, text, _ in futures:
        assert fut.done(), f"future left pending after close(): {text!r}"
        if fut.cancelled():
            continue
        if "poison" in text:
            with pytest.raises(ValueError):
                fut.result(timeout=0)
            n_poison += 1
        else:
            assert fut.result(timeout=0).text == text  # row identity survives the isolation re-dispatch
            n_ok += 1
    assert n_ok > 0 and n_poison > 0, (n_ok, n_poison)
    s = eng.stats()
    assert s["requests"] == len(futures)
    assert s["errors"] >= n_poison
    eng.close()
    with pytest.raises(RuntimeError):
        eng.submit("late")


def test_engine_dispatches_as_the_jax_engine_does():
    """Both engines on one fake backend, the same requests submitted inside
    one wait window: the same padded batches (texts, speakers, per-row seeds,
    program key) reach the backend, and the same counters come out."""
    def drive(engine_cls):
        backend = _FakeBackend()
        with engine_cls(backend, max_batch=4, max_wait_ms=400, seed=7) as eng:
            futs = [eng.submit("alpha", spk=1, seed=5), eng.submit("beta", spk=2),
                    eng.submit("poison gamma", spk=3, seed=9), eng.submit("delta", spk=4, n_timesteps=4),
                    eng.submit("epsilon", spk=5, keep_mel=True, temperature=0.5)]
            done = []
            for f in futs:
                try:
                    done.append(f.result(timeout=TIMEOUT).text)
                except ValueError as e:
                    done.append(repr(e))
            s = eng.stats()
        counters = {k: s[k] for k in ("requests", "batches", "batched_rows", "pad_rows", "errors",
                                      "failed_batches", "batch_hist", "mean_batch")}
        return sorted(backend.calls), done, counters

    ours, theirs = drive(BatchingEngine), drive(JaxBatchingEngine)
    # the port's engine also tells the backend how many rows are live: here, with distinct texts, those that are
    # not the last row repeated to the batch bucket
    calls = []
    for texts, spks, seeds, kw in ours[0]:
        kw = dict(kw)
        assert kw.pop("live_rows") == len(set(texts))
        calls.append((texts, spks, seeds, tuple(sorted(kw.items()))))
    assert (calls, *ours[1:]) == theirs
    calls, done, counters = ours
    assert done == ["alpha", "beta", "ValueError('poison text')", "delta", "epsilon"]
    assert counters["errors"] == 1 and counters["requests"] == 5
    # the first three share a key: one failed batch of 3 padded to 4, then three singletons
    merged = [c for c in calls if len(c[0]) == 4]
    assert [c[:3] for c in merged] == [(("alpha", "beta", "poison gamma", "poison gamma"), (1, 2, 3, 3), (5, 8, 9, 9))]
    assert len(calls) == 1 + 3 + 2


@pytest.mark.parametrize("engine", ["BatchingEngine", "OneThreadEngine"])
def test_profile_engine_measures_a_burst(pipe, engine):
    """The measuring script's burst on the tiny pipeline, through the engine
    and through the reference's one-thread order it is compared with: the same
    audio per request from both, and the numbers it reports."""
    from emojivoice_tpu_torch.inference import profile_engine

    requests = [(f"burst text {i}", i % 4, 50 + i) for i in range(8)]
    cls = getattr(profile_engine, engine) if engine == "OneThreadEngine" else BatchingEngine
    with cls(pipe, max_batch=4, max_wait_ms=20) as eng:
        served = profile_engine.burst(eng, requests, clients=4)
    assert not eng._worker.is_alive() and not eng._finalizer.is_alive()
    assert served["utt_per_s"] > 0 and 0 < served["latency_ms_p50"] <= served["latency_ms_p95"] <= served["latency_ms_max"]
    for (text, spk, seed), res in zip(requests, served["results"]):
        direct = pipe.synthesise([text], spks=[spk], n_timesteps=10, seed=seed, pcm16=True)[0]
        assert res.cleaned_text == text and res.mel_length == direct.mel_length
        np.testing.assert_allclose(res.wav, direct.wav, atol=1.01 / 32767)
    out = profile_engine.measure(pipe, requests, cls, max_batch=4, max_wait_ms=20)
    assert out["engine"] == engine and out["batches"] >= 2 and "results" not in out
    made = profile_engine.serving_requests(32, [79, 86, 3])
    assert len(made) == 32 and all(20 <= len(t) <= 201 and s in (79, 86, 3) for t, s, _ in made)
    assert made == profile_engine.serving_requests(32, [79, 86, 3]) and len({seed for _, _, seed in made}) == 32
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            profile_engine.main([])


# ---------------------------------------------------------------------------
# spans and counters
# ---------------------------------------------------------------------------

def _merged_batch(pipe):
    """Four requests merged into one batch of the tiny pipeline → stats()."""
    with BatchingEngine(pipe, max_batch=4, max_wait_ms=2000, batch_buckets=(1, 2, 4)) as eng:
        futs = [eng.submit(f"hello number {i}", spk=i, n_timesteps=2) for i in range(4)]
        for f in futs:
            assert f.result(timeout=TIMEOUT).mel_length > 0
        return eng.stats()


def test_no_span_is_recorded_with_tracing_off(pipe):
    obs.disable()
    obs.drain()
    assert _merged_batch(pipe)["batches"] == 1
    assert obs.drain() == []


def test_a_merged_batch_is_one_dispatch_with_the_pipelines_spans(pipe):
    """The recorder on: one ``engine.dispatch`` whose children are the
    pipeline's four stages, every row's request id once, the batch's id on
    the worker's and the results thread's spans."""
    obs.enable()
    try:
        s = _merged_batch(pipe)
    finally:
        obs.disable()
    spans = obs.drain()
    assert s["batches"] == 1
    (dispatch,) = [x for x in spans if x["name"] == "engine.dispatch"]
    bid = dispatch["batch"]
    assert sorted(dispatch["rids"]) == [0, 1, 2, 3]
    children = sorted((x for x in spans if x["parent"] == dispatch["id"]), key=lambda x: x["t0"])
    assert [x["name"] for x in children] == ["pipeline.frontend", "pipeline.stage_a", "pipeline.host_read",
                                            "pipeline.launch"]
    assert all(dispatch["t0"] <= x["t0"] <= x["t1"] <= dispatch["t1"] for x in children)
    by_name = {}
    for x in spans:
        by_name.setdefault(x["name"], []).append(x)
    for name in ("engine.collect", "engine.slot_wait"):
        (x,) = by_name[name]
        assert x["batch"] == bid and x["rids"] == dispatch["rids"] and x["thread"] == "batching-engine"
    assert by_name["engine.wait"][0]["batch"] == bid
    for name in ("engine.fetch", "engine.resolve"):
        (x,) = by_name[name]
        assert x["batch"] == bid and x["thread"] == "batching-engine-results" and x["t0"] >= dispatch["t1"]
    assert not any(x["name"].startswith("pipeline.") and x["parent"] != dispatch["id"] for x in spans)


def test_the_queue_wait_holds_the_collection_and_the_slot_wait(pipe):
    """Batch by batch: the new sums are non-negative, the pipeline's host
    phases were timed, and the collection window plus the slot wait is no
    more than the batch's summed queue wait."""
    keys = ("batches", "wait_s_sum", "collect_s_sum", "slot_wait_s_sum", "frontend_s_sum", "host_read_s_sum")
    with BatchingEngine(pipe, max_batch=2, max_wait_ms=30, batch_buckets=(1, 2)) as eng:
        prev = eng.stats()
        assert all(prev[k] == 0 for k in keys)
        for k in range(3):
            futs = [eng.submit(f"batch {k} row {i}", spk=i, n_timesteps=2) for i in range(2)]
            for f in futs:
                f.result(timeout=TIMEOUT)
            s = eng.stats()
            d = {key: s[key] - prev[key] for key in keys}
            assert d["batches"] == 1 and min(d.values()) >= 0, d
            assert d["frontend_s_sum"] > 0 and d["host_read_s_sum"] > 0
            assert 0 < d["collect_s_sum"] + d["slot_wait_s_sum"] <= d["wait_s_sum"], d
            prev = s


def test_counters_and_spans_under_sustained_load_on_a_backend_without_host_phases():
    """The fake backend reports no frontend or host read: those sums stay 0;
    every dispatched batch has its dispatch, fetch and resolve spans."""
    obs.enable()
    try:
        with BatchingEngine(_FakeBackend(), max_batch=4, max_wait_ms=1) as eng:
            futs = [eng.submit(f"utt {i}", spk=i % 3, seed=i) for i in range(40)]
            for f in futs:
                f.result(timeout=TIMEOUT)
            s = eng.stats()
    finally:
        obs.disable()
    spans = obs.drain()
    assert s["frontend_s_sum"] == s["host_read_s_sum"] == 0.0
    assert s["collect_s_sum"] + s["slot_wait_s_sum"] <= s["wait_s_sum"]
    batches = {x["batch"] for x in spans if x["name"] == "engine.dispatch"}
    assert len(batches) == s["batches"]
    for name in ("engine.fetch", "engine.resolve"):
        assert {x["batch"] for x in spans if x["name"] == name} == batches
    rids = [r for x in spans if x["name"] == "engine.dispatch" for r in x["rids"]]
    assert sorted(rids) == list(range(40))
