"""The serving front ends over an exported bundle: ``BundleSynthesisPipeline``
under the batching engine, the streaming strategies and ``webapp --bundle``.

The bundle is exported from the port's tiny CPU pipeline (weights carried
over from a flax init) at text bucket 64, mel bucket 128, batches (1, 2), 2
Euler steps and pcm16, as ``tests/test_export_and_obs.py::served_bundle``.
A seeded row inside a merged batch is held against the direct bundle call
with that seed within one pcm16 step (the batch-2 program sums in another
order than the batch-1 one, and the truncating cast flips by one where the
floats differ in the last digits).  ``/api/stream`` on a bundle answers 200
for ``auto`` (the full utterance) and 400 for a forced ``stream``: the code's
behaviour, which ``tests/test_export_and_obs.py::test_webapp_errors_are_http_statuses``
predates.
"""

import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from emojivoice_tpu_torch.apps import webapp
from emojivoice_tpu_torch.inference.export import BundleSynthesisPipeline, LoadedBundle, export_bundle
from emojivoice_tpu_torch.inference.serving import BatchingEngine
from emojivoice_tpu_torch.inference.streaming import auto_stream
from tests.test_torch_serving import bridged_pipeline

torch.set_num_threads(2)

TIMEOUT = 300
LSB = 1.01 / 32767.0


@pytest.fixture(scope="module")
def pipe():
    return bridged_pipeline(mel_buckets=(64, 128), text_buckets=(64,))


@pytest.fixture(scope="module")
def served_bundle(pipe, tmp_path_factory):
    d = tmp_path_factory.mktemp("served") / "bundle"
    export_bundle(pipe, str(d), text_buckets=[64], mel_buckets=[128], batches=(1, 2), n_timesteps=2, pcm16=True)
    return str(d)


@pytest.fixture(scope="module")
def bp(served_bundle):
    return BundleSynthesisPipeline(served_bundle, device="cpu")


def post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode(), headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_bundle_backed_serving_engine(bp, pipe):
    """Concurrent requests coalesce into one batch-2 program call, and a
    seeded request inside it reproduces the direct bundle call."""
    assert bp.batch_buckets == (1, 2) and bp.n_timesteps == 2 and bp.denoiser_strength == 0.00025
    with BatchingEngine(bp, max_batch=2, max_wait_ms=2000, batch_buckets=bp.batch_buckets) as eng:
        with ThreadPoolExecutor(2) as ex:
            futs = [ex.submit(lambda s: eng.submit(f"request {s}", spk=s, seed=100 + s).result(TIMEOUT), i)
                    for i in range(2)]
            merged = [f.result(timeout=TIMEOUT) for f in futs]
        s = eng.stats()
        assert s["requests"] == 2 and s["batches"] <= 2 and s["errors"] == 0
        for r in merged:
            assert r.wav.dtype == np.float32 and len(r.wav) == r.mel_length * 16 > 0 and r.cleaned_text
            assert r.mel.size == 0  # a vocoder bundle carries no mel
        direct = bp.synthesise(["request 1"], spks=[1], n_timesteps=2, seed=[101])[0]
        np.testing.assert_allclose(merged[1].wav, direct.wav, atol=LSB)
        # the live pipeline's per-row-seed call at the bundle's mel bucket, pcm16 as the bundle
        want = pipe.synthesise(["request 1"], spks=[1], n_timesteps=2, seed=[101], fused=True, fused_mel_bucket=128,
                               pcm16=True)[0]
        np.testing.assert_array_equal(direct.wav, want.wav)
        with pytest.raises(ValueError, match="n_timesteps"):
            eng.submit("x", n_timesteps=7).result(timeout=TIMEOUT)
    bp.warmup(n_timesteps=2, batch=1)
    with pytest.raises(ValueError, match="not in exported grid"):
        bp.warmup(n_timesteps=2, batch=64)
    with pytest.raises(ValueError, match="n_timesteps"):
        bp.warmup(n_timesteps=10)


def test_streaming_over_a_bundle(bp):
    """``auto_stream`` falls back to the full utterance on a bundle (it has
    no mel-only call to stream from) and a forced ``stream`` is refused."""
    full = bp.synthesise(["streamed from a bundle"], spks=[1], seed=3)[0]
    chunks = list(auto_stream(bp, "streamed from a bundle", spk=1, seed=3))
    assert len(chunks) == 1
    np.testing.assert_array_equal(chunks[0], full.wav)
    with pytest.raises(ValueError, match="live pipeline"):
        list(auto_stream(bp, "streamed from a bundle", spk=1, seed=3, strategy="stream"))


def test_webapp_serves_exported_bundle(bp):
    """``serve`` on a bundle: the engine takes the exported batch grid, the
    JSON API and the form path answer, the form posts the bundle's steps;
    a wrong step count answers 400; ``/api/stream`` 200 for auto, 400 for
    a forced stream."""
    server = webapp.serve(bp, port=0, batching=True, max_batch=8, max_wait_ms=5)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        assert server.engine.batch_buckets == (1, 2) and server.engine.max_batch == 2
        status, body = post(url + "/api/synthesise", {"text": "bundle serving", "steps": 2, "spk": 1})
        out = json.loads(body)
        assert status == 200 and out["num_samples"] > 0 and out["cleaned_text"]
        form = urllib.request.Request(url + "/synthesise",
                                      data=b"text=hello+bundle&steps=2&temperature=0.667&length_scale=1.0&spk=1")
        with urllib.request.urlopen(form, timeout=TIMEOUT) as r:
            page = r.read().decode()
        assert "audio controls" in page and "<img" not in page  # no mel in a vocoder bundle
        with urllib.request.urlopen(url + "/", timeout=TIMEOUT) as r:
            assert 'name="steps" type="number" value="2"' in r.read().decode()
        status, body = post(url + "/api/synthesise", {"text": "wrong steps", "steps": 7, "spk": 1})
        assert status == 400 and "n_timesteps" in body.decode()
        status, body = post(url + "/api/stream", {"text": "stream from a bundle", "spk": 1})
        assert status == 200 and body[:4] == b"RIFF" and len(body) > 44
        status, body = post(url + "/api/stream", {"text": "stream from a bundle", "spk": 1, "strategy": "auto"})
        assert status == 200 and body[:4] == b"RIFF"
        status, body = post(url + "/api/stream", {"text": "stream from a bundle", "spk": 1, "strategy": "stream"})
        assert status == 400 and "live pipeline" in body.decode()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(TIMEOUT)
        server.engine.close()
    assert not thread.is_alive()


def test_webapp_main_bundle_flag_conflicts(served_bundle):
    for extra in (["--random_init"], ["--checkpoint_path", "x.ckpt"], ["--vocoder", "g"], ["--model", "b=random"]):
        with pytest.raises(SystemExit):
            webapp.main(["--cpu", "--bundle", served_bundle] + extra)


def test_bundle_serving_defaults_and_rejections(pipe, tmp_path):
    """An engine request with no operating point takes the bundle's own
    (a non-default denoiser strength here); explicit mismatches and an
    unknown language are refused, a known one overrides the cleaners."""
    export_bundle(pipe, str(tmp_path / "od"), text_buckets=[64], mel_buckets=[128], batches=(1,), n_timesteps=2,
                  denoiser_strength=0.001, pcm16=True)
    bp = BundleSynthesisPipeline(str(tmp_path / "od"), device="cpu")
    assert bp.denoiser_strength == 0.001
    with BatchingEngine(bp, max_batch=1, max_wait_ms=1, batch_buckets=bp.batch_buckets) as eng:
        assert len(eng.submit("operating point", spk=1).result(timeout=TIMEOUT).wav) > 0
        with pytest.raises(ValueError, match="denoiser_strength"):
            eng.submit("x", denoiser_strength=0.5).result(timeout=TIMEOUT)
    with pytest.raises(KeyError, match="Unknown language"):
        BundleSynthesisPipeline(str(tmp_path / "od"), language="xx", device="cpu")
    fr = BundleSynthesisPipeline(LoadedBundle(str(tmp_path / "od"), device="cpu"), language="fr")
    assert fr.synthesise(["Ça va"], spks=[1], seed=0)[0].cleaned_text == pipe.encode_texts(["Ça va"], "fr")[2][0]
