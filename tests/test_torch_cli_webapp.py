"""The port's CLI (``inference/cli.py``) and webapp (``apps/webapp.py``).

The parser's option strings and defaults and the stream's WAV header must
equal the JAX package's; the webapp's HTTP statuses are those that
``tests/test_streaming_and_demos.py`` and ``tests/test_serving.py`` pin for the
JAX webapp (exported bundles aside), at the tiny config on the CPU with
weights carried over from a flax init.  A stress test drives the batching
engine and ``/api/stream`` handler threads at once.  pcm16 bodies are held to
one int16 step (1.01 / 32767).  Every HTTP call has a timeout; servers bind
port 0.
"""

import json
import struct
import threading
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from scipy.io import wavfile

from emojivoice_tpu.apps import webapp as jax_webapp
from emojivoice_tpu.inference import cli as jax_cli
from emojivoice_tpu_torch.apps import webapp
from emojivoice_tpu_torch.inference import cli
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.inference.streaming import stream_synthesise
from tests.test_pipeline import tiny_root
from tests.test_torch_serving import bridged_pipeline, port_root

torch.set_num_threads(2)

TIMEOUT = 120
BUCKETS = dict(mel_buckets=(64, 128, 256), text_buckets=(64, 128))


@pytest.fixture(scope="module")
def pipe():
    return bridged_pipeline(**BUCKETS)


@pytest.fixture
def tiny_from_random(monkeypatch):
    """``SynthesisPipeline.from_random`` at the tiny config whatever preset
    the caller names (the CLI's is emoji_multi); records the keywords."""
    calls = []
    real = SynthesisPipeline.from_random.__func__

    def from_random(cls, root_cfg=None, seed=0, **kw):
        calls.append(kw)
        return real(cls, port_root(tiny_root()), seed, **BUCKETS, **kw)

    monkeypatch.setattr(SynthesisPipeline, "from_random", classmethod(from_random))
    return calls


class Served:
    """A webapp on port 0 in a thread, shut down (engine included) on exit."""

    def __init__(self, pipe, **kw):
        self.server = webapp.serve(pipe, port=0, **kw)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(TIMEOUT)
        if self.server.engine is not None:
            self.server.engine.close()

    def get(self, path):
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}", timeout=TIMEOUT) as r:
            return r.read()

    def post(self, path, body, ctype="application/json"):
        data = json.dumps(body).encode() if isinstance(body, dict) else body
        req = urllib.request.Request(f"http://127.0.0.1:{self.port}{path}", data=data,
                                     headers={"Content-Type": ctype} if ctype else {})
        return urllib.request.urlopen(req, timeout=TIMEOUT)

    def post_json(self, path, body):
        with self.post(path, body) as r:
            return json.loads(r.read())

    def status(self, path, body, ctype="application/json"):
        try:
            with self.post(path, body, ctype) as r:
                return r.status, r.read().decode(errors="replace")
        except urllib.error.HTTPError as e:
            return e.code, e.read().decode()

    def stream(self, body):
        with self.post("/api/stream", body) as r:
            assert r.headers["Content-Type"] == "audio/wav"
            raw = r.read()
        assert raw[:4] == b"RIFF" and raw[8:12] == b"WAVE"
        assert struct.unpack("<I", raw[4:8])[0] == 0xFFFFFFFF and struct.unpack("<I", raw[24:28])[0] == 22050
        return np.frombuffer(raw[44:], dtype="<i2").astype(np.float32) / 32767.0


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _options(parser):
    return sorted((tuple(a.option_strings), a.default, a.type, a.nargs, tuple(a.choices) if a.choices else None,
                   type(a).__name__) for a in parser._actions)


def test_parser_options_and_defaults_equal_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)  # --output_folder defaults to the working directory
    assert _options(cli.build_parser()) == _options(jax_cli.build_parser())
    argv = ["--text", "hi", "--spk", "7", "--steps", "4", "--speaking_rate", "0.9", "--batched", "--seed", "3"]
    assert vars(cli.build_parser().parse_args(argv)) == vars(jax_cli.build_parser().parse_args(argv))
    assert "matplotlib" in cli.build_parser().format_help() and "sounddevice" in cli.build_parser().format_help()


@pytest.mark.parametrize("sr,channels,bits", [(22050, 1, 16), (16000, 2, 16), (44100, 1, 24)])
def test_wav_stream_header_equals_jax(sr, channels, bits):
    header = webapp._wav_stream_header(sr, channels, bits)
    assert header == jax_webapp._wav_stream_header(sr, channels, bits) and len(header) == 44


def test_cli_text_mode_writes_wav_npy_png(tiny_from_random, tmp_path, capsys):
    assert cli.main(["--random_init", "--cpu", "--text", "hello from the command line", "--steps", "2", "--spk", "1",
                     "--seed", "0", "--output_folder", str(tmp_path)]) == 0
    assert tiny_from_random == [{"cleaners": ("english_cleaners2",), "device": "cpu"}]
    (wav,) = tmp_path.glob("utterance_*.wav")
    sr, audio = wavfile.read(wav)
    mel = np.load(wav.with_suffix(".npy"))
    assert sr == 22050 and audio.dtype == np.float32 and np.isfinite(audio).all()
    assert mel.shape[1] == 12 and audio.shape == (mel.shape[0] * 16,)
    assert wav.with_suffix(".png").stat().st_size > 0
    assert "RTF" in capsys.readouterr().out


def test_cli_file_modes_and_interactive(tiny_from_random, tmp_path, monkeypatch):
    script = tmp_path / "script.txt"
    script.write_text("first line|2\n\nsecond line\nthird line|1\n")
    common = ["--cpu", "--random_init", "--steps", "2", "--seed", "1", "--spk", "3", "--file", str(script)]
    assert cli.main(common + ["--output_folder", str(tmp_path / "one")]) == 0
    assert cli.main(common + ["--batched", "--batch_size", "2", "--output_folder", str(tmp_path / "batched")]) == 0
    for folder in ("one", "batched"):
        names = sorted(p.name for p in (tmp_path / folder).glob("*.wav"))
        assert names == ["utterance_000.wav", "utterance_001.wav", "utterance_002.wav"], folder
    # per-line speakers reach the pipeline: one call per line, or padded batches of --batch_size
    seen = []
    real = SynthesisPipeline.synthesise
    monkeypatch.setattr(SynthesisPipeline, "synthesise",
                        lambda self, texts, spks=None, **kw: seen.append((list(texts), list(spks))) or
                        real(self, texts, spks=spks, **kw))
    cli.main(common + ["--batched", "--batch_size", "2", "--output_folder", str(tmp_path / "again")])
    assert seen == [(["first line", "second line"], [2, 3]), (["third line"], [1])]
    answers = iter(["typed text", "2", ""])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(answers))
    assert cli.main(["--cpu", "--steps", "2", "--output_folder", str(tmp_path / "inter")]) == 0
    assert [p.name for p in (tmp_path / "inter").glob("*.wav")] == ["interactive_000.wav"]
    assert seen[-1] == (["typed text"], [2])


def test_cli_png_and_playback_degrade_without_their_packages(tiny_from_random, tmp_path, monkeypatch):
    import builtins

    real_import = builtins.__import__

    def no_extras(name, *a, **kw):
        if name.split(".")[0] in ("matplotlib", "sounddevice"):
            raise ImportError(f"No module named {name!r}")
        return real_import(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_extras)
    with pytest.warns(UserWarning) as caught:
        assert cli.main(["--cpu", "--random_init", "--text", "no extras here", "--steps", "2", "--play",
                         "--output_folder", str(tmp_path)]) == 0
    messages = " ".join(str(w.message) for w in caught)
    assert "matplotlib unavailable" in messages and "audio playback unavailable" in messages
    assert len(list(tmp_path.glob("*.wav"))) == 1 and len(list(tmp_path.glob("*.npy"))) == 1
    assert not list(tmp_path.glob("*.png"))


def test_cli_loads_checkpoint_dir_and_file(tmp_path, monkeypatch):
    """--checkpoint_path: a directory goes to from_checkpoint, a file to
    from_torch_checkpoints, a bare name through the cache directory."""
    calls = []
    monkeypatch.setattr(SynthesisPipeline, "from_checkpoint",
                        classmethod(lambda cls, *a, **kw: calls.append(("dir", a, kw))))
    monkeypatch.setattr(SynthesisPipeline, "from_torch_checkpoints",
                        classmethod(lambda cls, *a, **kw: calls.append(("file", a, kw))))
    monkeypatch.setenv("EMOJIVOICE_HOME", str(tmp_path / "home"))
    ckpts = tmp_path / "ckpts"
    ckpts.mkdir()
    cached = tmp_path / "home" / "emojivoice" / "my-voice.ckpt"
    cached.parent.mkdir(parents=True)
    cached.write_bytes(b"x")
    parse = cli.build_parser().parse_args
    cli._load_pipeline(parse(["--checkpoint_path", str(ckpts), "--cpu", "--language", "fr"]))
    cli._load_pipeline(parse(["--checkpoint_path", "my-voice.ckpt", "--vocoder", str(cached)]))
    assert calls == [("dir", (str(ckpts), None), {"cleaners": ("french_cleaners",), "device": "cpu"}),
                     ("file", (str(cached), str(cached)), {"cleaners": ("english_cleaners2",), "device": "cuda"})]
    with pytest.raises(FileNotFoundError, match="not a known released asset"):
        cli._load_pipeline(parse(["--checkpoint_path", "absent.ckpt"]))


# ---------------------------------------------------------------------------
# webapp
# ---------------------------------------------------------------------------

def test_webapp_http(pipe):
    with Served(pipe) as app:
        assert b"emojivoice-tpu" in app.get("/")
        assert json.loads(app.get("/health")) == {"ok": True}
        assert json.loads(app.get("/api/models")) == {"models": ["default"], "primary": "default"}
        out = app.post_json("/api/synthesise", {"text": "hello web", "steps": 2, "spk": 1})
        assert out["num_samples"] > 0 and out["sample_rate"] == 22050 and out["model"] == "default"
        assert app.status("/api/synthesise", {"text": ""})[0] == 400
        assert app.status("/nowhere", {"text": "x"})[0] == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            app.get("/nowhere")
        assert e.value.code == 404
        # the form path renders the page with audio and the mel image
        status, page = app.status("/synthesise", b"text=form+post&steps=2&spk=1", "application/x-www-form-urlencoded")
        assert status == 200 and "audio controls" in page and "data:image/png" in page and "Phonetised" in page


def test_webapp_multi_model_compare(pipe):
    other = SynthesisPipeline.from_random(port_root(tiny_root()), seed=5, device="cpu", cleaners=("basic_cleaners",),
                                          **BUCKETS)
    defaults = {"text": "hi", "steps": 2, "temperature": 0.667, "length_scale": 1.0, "spk": 1}
    with Served(pipe, extra_models={"alt": other}, cache_example_texts=("tiny example",), defaults=defaults) as app:
        assert json.loads(app.get("/api/models")) == {"models": ["default", "alt"], "primary": "default"}
        page = app.get("/").decode()
        assert '<select name="model">' in page and "Cached examples" in page
        assert page.count("audio controls") >= 2  # one example per model
        one = app.post_json("/api/synthesise", {"text": "hello compare", "steps": 2, "spk": 1, "model": "alt"})
        assert one["model"] == "alt" and one["num_samples"] > 0
        both = app.post_json("/api/synthesise", {"text": "hello compare", "steps": 2, "spk": 1, "compare": 1})
        assert [b["model"] for b in both["compare"]] == ["default", "alt"]
        assert all(b["num_samples"] > 0 for b in both["compare"])
        assert app.status("/api/synthesise", {"text": "x", "model": "nope"})[0] == 400
    with pytest.raises(ValueError, match="collides"):
        webapp.make_handler(pipe, defaults, models={"default": other})


def test_webapp_stream_endpoint(pipe):
    with Served(pipe) as app:
        # forced chunked-vocoder path: the samples of stream_synthesise
        got = app.stream({"text": "stream me", "steps": 2, "spk": 1, "seed": 11, "strategy": "stream"})
        ref = np.clip(np.concatenate(list(stream_synthesise(pipe, "stream me", spk=1, n_timesteps=2, seed=11))), -1, 1)
        assert len(got) == len(ref)
        np.testing.assert_allclose(got, ref, atol=1.01 / 32767.0)
        # default auto-select: a short single sentence is one full call
        got_auto = app.stream({"text": "stream me", "steps": 2, "spk": 1, "seed": 11})
        ref_full = np.clip(pipe.synthesise(["stream me"], spks=[1], n_timesteps=2, seed=11)[0].wav, -1, 1)
        assert len(got_auto) == len(ref_full)
        np.testing.assert_allclose(got_auto, ref_full, atol=1.01 / 32767.0)
        # multi-sentence text: pipelined segments with gaps
        piped = app.stream({"text": "One sentence. Two sentences.", "steps": 2, "spk": 1, "seed": 1, "strategy": "pipelined"})
        assert len(piped) > len(got_auto)
        for payload in (b"text=", b"text=hi&strategy=bogus"):
            assert app.status("/api/stream", payload, None)[0] == 400


def test_webapp_error_statuses(pipe):
    """Request faults answer real HTTP statuses on every endpoint: malformed
    JSON and numerics are a 400, an unknown language 400s before the stream's
    response starts, a text beyond the largest bucket is the request's fault,
    and a backend fault is a 500."""
    with Served(pipe) as app:
        for path in ("/api/synthesise", "/api/stream"):
            assert app.status(path, b"{bad json")[0] == 400
            assert app.status(path, b"[1, 2]")[0] == 400
            assert app.status(path, {"text": "x", "seed": "not-a-number"})[0] == 400
            status, body = app.status(path, {"text": "hi", "steps": 2, "language": "zz"})
            assert status == 400 and "zz" in body
            assert app.status(path, {"text": "word " * 200, "steps": 2})[0] == 400  # overflows the text buckets
        assert app.post_json("/api/synthesise", {"text": "hello", "steps": 2, "language": "en"})["num_samples"] > 0
        assert len(app.stream({"text": "hello", "steps": 2, "language": "en"})) > 0

        def broken(*a, **kw):
            raise RuntimeError("device fell over")

        pipe.synthesise = broken
        try:
            status, body = app.status("/api/synthesise", {"text": "hello", "steps": 2})
            assert status == 500 and "device fell over" in body
            assert app.status("/api/stream", {"text": "hello", "steps": 2})[0] == 500
        finally:
            del pipe.synthesise


def test_webapp_with_batching(pipe):
    """Concurrent HTTP requests coalesce into one padded-batch call."""
    with Served(pipe, batching=True, max_batch=4, max_wait_ms=1500) as app:
        with ThreadPoolExecutor(4) as ex:
            outs = list(ex.map(lambda i: app.post_json("/api/synthesise", {"text": f"request {i}", "steps": 2, "spk": i}),
                               range(4)))
        assert all(o["num_samples"] > 0 for o in outs)
        s = app.server.engine.stats()
        assert s["requests"] == 4 and s["batches"] <= 2  # 1 expected; 2 tolerated for thread-start skew
        health = json.loads(app.get("/health"))
        assert health["ok"] and health["serving"]["requests"] == 4
        assert app.status("/api/synthesise", {"text": "x", "seed": "not-a-number"})[0] == 400
        # a seeded request through the engine replays the direct call
        out = app.post_json("/api/synthesise", {"text": "seeded", "steps": 2, "spk": 1, "seed": 4})
        assert out["num_samples"] == len(pipe.synthesise(["seeded"], spks=[1], n_timesteps=2, seed=4)[0].wav)


def test_webapp_engine_and_stream_under_concurrency(pipe):
    """Handler threads stream (direct pipeline calls) while the engine's
    worker dispatches batches: every request answers in full, and a seeded
    stream under load carries the samples it carries alone."""
    alone = np.clip(np.concatenate(list(stream_synthesise(pipe, "stream 0 here", spk=1, n_timesteps=2, seed=0))), -1, 1)
    with Served(pipe, batching=True, max_batch=4, max_wait_ms=20) as app:
        def synth(i):
            return app.post_json("/api/synthesise", {"text": f"batched request {i}", "steps": 2, "spk": i % 4, "seed": i})

        def stream(k):
            return app.stream({"text": f"stream {k} here", "steps": 2, "spk": 1, "seed": k, "strategy": "stream"})

        with ThreadPoolExecutor(8) as ex:
            synths = [ex.submit(synth, i) for i in range(12)]
            streams = [ex.submit(stream, k) for k in range(4)]
            outs = [f.result(timeout=TIMEOUT) for f in synths]
            bodies = [f.result(timeout=TIMEOUT) for f in streams]
        assert all(o["num_samples"] > 0 for o in outs)
        assert all(len(b) > 0 and np.isfinite(b).all() for b in bodies)
        np.testing.assert_allclose(bodies[0], alone, atol=1.01 / 32767.0)
        s = app.server.engine.stats()
        assert s["requests"] == 12 == s["batched_rows"] and s["errors"] == 0


def test_webapp_main_flags(tiny_from_random, monkeypatch):
    """``main`` builds the pipelines its flags name and hands them to
    ``serve``; it has every flag of the JAX webapp (``--bundle``, which
    serves an exported bundle alone, is driven in
    ``tests/test_torch_export_serving.py``)."""
    served = {}

    class Stub:
        engine = None

        def serve_forever(self):
            served["ran"] = True

    def fake_serve(pipe, host, port, **kw):
        served.update(pipe=pipe, host=host, port=port, **kw)
        return Stub()

    monkeypatch.setattr(webapp, "serve", fake_serve)
    assert webapp.main(["--cpu", "--random_init", "--port", "0", "--batching", "--max_batch", "4", "--max_wait_ms", "5",
                        "--model", "alt=random", "--cache_examples", "--language", "de"]) == 0
    assert served["ran"] and served["pipe"].device.type == "cpu" and served["pipe"].cleaners == ("german_cleaners",)
    assert served["batching"] and served["max_batch"] == 4 and served["max_wait_ms"] == 5.0
    assert list(served["extra_models"]) == ["alt"] and served["cache_example_texts"] == webapp.EXAMPLE_TEXTS
    assert all(kw["device"] == "cpu" for kw in tiny_from_random) and len(tiny_from_random) == 2
    with pytest.raises(SystemExit):
        webapp.main(["--cpu", "--model", "default=random"])
    with pytest.raises(SystemExit):
        webapp.main(["--cpu", "--bundle", "somewhere", "--random_init"])


@pytest.mark.parametrize("script,target", [
    ("emojivoice-tts-torch", "emojivoice_tpu_torch.inference.cli:main"),
    ("emojivoice-tts-app-torch", "emojivoice_tpu_torch.apps.webapp:main"),
    ("emojivoice-train-torch", "emojivoice_tpu_torch.training.train:main"),
])
def test_console_scripts_of_the_port(script, target, capsys):
    """The port's scripts stand in pyproject.toml beside the JAX package's,
    and ``--help`` exits 0 without building a pipeline."""
    import importlib
    import tomllib
    from pathlib import Path

    scripts = tomllib.loads((Path(__file__).resolve().parents[1] / "pyproject.toml").read_text())["project"]["scripts"]
    assert scripts[script] == target and scripts[script.removesuffix("-torch")].startswith("emojivoice_tpu.")
    mod, fn = target.split(":")
    with pytest.raises(SystemExit) as exc:
        getattr(importlib.import_module(mod), fn)(["--help"])
    assert exc.value.code == 0 and "usage" in capsys.readouterr().out
