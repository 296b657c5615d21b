"""`emojivoice-tts-app-torch`: browser demo and HTTP API on the PyTorch port
(port of ``emojivoice_tpu.apps.webapp``, minus exported bundles).

Controls: text, ODE steps, temperature, length scale, speaker id; the
response shows the phonetized text, the mel image (where matplotlib is
installed), and playable audio.  ``POST /api/synthesise`` answers JSON,
``POST /api/stream`` a progressive WAV.  Implemented on the stdlib
http.server.  Runs on the card unless ``--cpu`` is given.

Handler threads and the batching engine's worker issue work onto one CUDA
stream; kernels of two requests may interleave there, and nothing they share
is written concurrently (the vocoder's packed weights are made once under a
lock, every request owns its tensors and pinned buffers).
"""

from __future__ import annotations

import argparse
import base64
import html
import io
import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs

_PAGE = """<!DOCTYPE html>
<html><head><title>emojivoice-tpu (torch)</title>
<style>
 body {{ font-family: system-ui, sans-serif; margin: 2rem auto; max-width: 780px; }}
 textarea, input, select {{ width: 100%; margin: .25rem 0 .75rem; }}
 .row {{ display: flex; gap: 1rem; }} .row > div {{ flex: 1; }}
 img {{ max-width: 100%; }}
 .out {{ background: #f6f6f6; padding: 1rem; border-radius: 8px; margin-top: 1rem; }}
</style></head>
<body>
<h2>🍵 emojivoice-tpu synthesis (PyTorch port)</h2>
<form method="post" action="/synthesise">
 <label>Text</label>
 <textarea name="text" rows="3">{text}</textarea>
 <div class="row">
  <div><label>ODE steps</label><input name="steps" type="number" value="{steps}"></div>
  <div><label>Temperature</label><input name="temperature" step="0.001" type="number" value="{temperature}"></div>
  <div><label>Length scale</label><input name="length_scale" step="0.05" type="number" value="{length_scale}"></div>
  <div><label>Speaker</label><input name="spk" type="number" value="{spk}"></div>
 </div>
 {model_row}
 <button type="submit">Synthesise</button>
</form>
{result}
{examples}
</body></html>"""


def _model_row(models, selected: str) -> str:
    """Model select + side-by-side compare toggle — shown only when more
    than one checkpoint is loaded (the reference demo serves two models)."""
    if len(models) <= 1:
        return ""
    opts = "".join(
        f'<option value="{html.escape(n)}"{" selected" if n == selected else ""}>'
        f"{html.escape(n)}</option>" for n in models)
    return (f'<div class="row"><div><label>Model</label>'
            f'<select name="model">{opts}</select></div>'
            f'<div><label>Compare all models (same text/seed)</label>'
            f'<input name="compare" type="checkbox" value="1"></div></div>')


def _render_result(res, title: str = "") -> str:
    import numpy as np
    from scipy.io import wavfile

    buf = io.BytesIO()
    wavfile.write(buf, res.sample_rate, np.clip(res.wav, -1, 1).astype(np.float32))
    audio_b64 = base64.b64encode(buf.getvalue()).decode()

    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:  # the mel image is optional
        plt = None
    img_tag = ""
    if res.mel.size and plt is not None:
        fig, ax = plt.subplots(figsize=(10, 2.5))
        ax.imshow(res.mel.T, aspect="auto", origin="lower", interpolation="none")
        fig.tight_layout()
        img_buf = io.BytesIO()
        fig.savefig(img_buf, format="png")
        plt.close(fig)
        img_tag = f'<img src="data:image/png;base64,{base64.b64encode(img_buf.getvalue()).decode()}">'

    head = f"<p><b>{html.escape(title)}</b></p>" if title else ""
    return f"""<div class="out">{head}
 <p><b>Phonetised:</b> {html.escape(res.cleaned_text)}</p>
 <p><b>RTF:</b> {res.rtf:.4f} &nbsp; <b>RTF+vocoder:</b> {res.rtf_w:.4f}</p>
 <audio controls src="data:audio/wav;base64,{audio_b64}"></audio>
 {img_tag}
</div>"""


def _wav_stream_header(sample_rate: int, channels: int = 1, bits: int = 16) -> bytes:
    """RIFF/WAVE header for a stream of unknown length: the RIFF and data
    sizes are 0xFFFFFFFF (the de-facto 'until EOF' convention — players and
    browsers read progressively and stop at connection close)."""
    import struct

    byte_rate = sample_rate * channels * bits // 8
    return (b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVE"
            + b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate,
                                    byte_rate, channels * bits // 8, bits)
            + b"data" + struct.pack("<I", 0xFFFFFFFF))


def make_handler(pipeline, defaults, engine=None, models=None, examples_html=""):
    """models: {name: pipeline} for the reference demo's multi-checkpoint
    compare; pipeline stays the primary (and the only one
    the batching engine fronts).  examples_html: pre-cached canonical
    examples rendered into the index page."""
    models = models or {}
    if pipeline not in models.values():
        if "default" in models:
            # an extra model named "default" would shadow the primary in the
            # merged dict and the primary-name lookup below would fail
            raise ValueError("extra model name 'default' collides with the "
                             "primary pipeline; pick another --model name")
        models = {"default": pipeline, **models}
    primary = next(n for n, p in models.items() if p is pipeline)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _page(self, result="", model=None, **over):
            ctx = {**defaults,
                   "model_row": _model_row(models, model or primary),
                   "examples": examples_html, "result": result}
            ctx.update(over)
            return _PAGE.format(**ctx)

        def _send(self, body: str, status=200, ctype="text/html; charset=utf-8"):
            data = body.encode()
            self.send_response(status)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):
            if self.path in ("/", "/index.html"):
                self._send(self._page())
            elif self.path == "/health":
                body = {"ok": True}
                if engine is not None:
                    body["serving"] = engine.stats()
                self._send(json.dumps(body), ctype="application/json")
            elif self.path == "/api/models":
                self._send(json.dumps({"models": list(models), "primary": primary}),
                           ctype="application/json")
            else:
                self._send("not found", 404)

        def _read_form(self):
            """Parse the POST body (JSON or urlencoded form) → dict, or None
            after answering 400 — malformed JSON must not escape as a
            traceback/connection-reset before any status is sent."""
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length).decode()
            if self.headers.get("Content-Type", "").startswith("application/json"):
                try:
                    form = json.loads(raw)
                except json.JSONDecodeError as e:
                    self._send(f"bad json body: {e}", 400)
                    return None
                if not isinstance(form, dict):
                    self._send("json body must be an object", 400)
                    return None
                return form
            return {k: v[0] for k, v in parse_qs(raw).items()}

        def _parse_params(self, form):
            """Shared numeric/operating-point parsing → (params, spk), or
            None after answering 400.  Malformed numerics must answer 400,
            not kill the handler thread mid-response."""
            try:
                params = dict(
                    n_timesteps=int(form.get("steps", defaults["steps"])),
                    temperature=float(form.get("temperature", defaults["temperature"])),
                    length_scale=float(form.get("length_scale", defaults["length_scale"])),
                )
                # optional reproducibility: the same seed replays the same
                # noise stream on both the batching-engine and direct paths
                if form.get("seed") not in (None, ""):
                    params["seed"] = int(form["seed"])
                if form.get("language"):
                    params["language"] = str(form["language"])
                spk = int(form.get("spk", defaults["spk"]))
            except (TypeError, ValueError) as e:
                self._send(f"bad numeric field: {e}", 400)
                return None
            return params, spk

        def do_POST(self):
            if self.path == "/api/stream":
                self._stream()
                return
            if self.path not in ("/synthesise", "/api/synthesise"):
                self._send("not found", 404)
                return
            form = self._read_form()
            if form is None:
                return
            text = str(form.get("text", "")).strip()
            if not text:
                self._send("text required", 400)
                return
            parsed = self._parse_params(form)
            if parsed is None:
                return
            params, spk = parsed
            mname = str(form.get("model", primary))
            if mname not in models:
                self._send(f"unknown model {mname!r}; loaded: {list(models)}", 400)
                return
            compare = bool(form.get("compare")) and len(models) > 1
            if compare and "seed" not in params:
                params["seed"] = 0  # a compare is only meaningful same-seed
            # The HTML UI shows the mel image, so the form path opts into
            # it; the JSON API keeps the lean audio-only payload (pcm16 on
            # the wire, mel skipped) on BOTH the engine and direct paths.
            want_mel = self.path == "/synthesise"
            run = list(models.items()) if compare else [(mname, models[mname])]
            results = []
            try:
                for name, pl in run:
                    if engine is not None and pl is pipeline and not compare:
                        # dynamic batching: concurrent HTTP threads coalesce
                        # into one padded-batch call (inference/serving.py);
                        # compare renders are direct per-model
                        res = engine.synthesise(text, spk=spk, keep_mel=want_mel, **params)
                    else:
                        res = pl.synthesise([text], spks=[spk], keep_mel=want_mel,
                                            pcm16=True, **params)[0]
                    results.append((name, res))
            except (ValueError, KeyError) as e:
                # unknown language, bucket overflow: the request's fault → 400
                self._send(f"bad request: {e}", 400)
                return
            except Exception as e:  # noqa: BLE001 — backend fault → 500, not
                # a connection reset from a dead handler thread
                self._send(f"synthesis failed: {type(e).__name__}: {e}", 500)
                return
            if self.path == "/api/synthesise":
                payload = [{
                    "model": name,
                    "cleaned_text": res.cleaned_text,
                    "rtf": res.rtf,
                    "rtf_w": res.rtf_w,
                    "sample_rate": res.sample_rate,
                    "num_samples": int(len(res.wav)),
                } for name, res in results]
                body = {"compare": payload} if compare else payload[0]
                self._send(json.dumps(body), ctype="application/json")
            else:
                blocks = "".join(
                    _render_result(res, title=name if len(run) > 1 else "")
                    for name, res in results)
                self._send(self._page(result=blocks, model=mname,
                                      text=html.escape(text), spk=spk))

        def _stream(self):
            """POST /api/stream — progressive WAV: audio bytes start flowing
            after the first vocoder chunk instead of after the full
            utterance.  The body streams until EOF (no Content-Length);
            browsers and curl play it progressively.  The strategy (full
            one-shot / pipelined per-sentence / chunked vocoder) is
            auto-selected per request from the predicted audio length
            (inference/streaming.py choose_strategy); `strategy=` forces
            one."""
            import numpy as np

            form = self._read_form()
            if form is None:
                return
            text = str(form.get("text", "")).strip()
            if not text:
                self._send("text required", 400)
                return
            parsed = self._parse_params(form)
            if parsed is None:
                return
            kw, spk = parsed
            from emojivoice_tpu_torch.inference.pipeline import SAMPLE_RATE
            from emojivoice_tpu_torch.inference.streaming import auto_stream

            # auto-select: full / pipelined / chunked-stream chosen from the
            # text's predicted audio length.  `strategy` in the form forces
            # one for debugging/benchmarks.
            strategy = form.get("strategy") or None
            if strategy not in (None, "auto", "full", "pipelined", "stream"):
                self._send(f"unknown strategy {strategy!r}", 400)
                return
            if strategy == "auto":
                strategy = None
            gen = auto_stream(pipeline, text, spk=spk, strategy=strategy, **kw)

            # Pre-flight: pull the FIRST chunk before any header goes out.
            # auto_stream is a lazy generator, so request faults (unknown
            # language, bucket overflow) would otherwise surface at first
            # next() — after the 200 — leaving the client a "successful"
            # empty WAV.  Materializing chunk 0 here lets those map to
            # 400/500 like the non-stream path; it costs nothing (chunk 0
            # had to be computed before any byte could flow anyway).
            try:
                first_chunk = next(gen, None)
            except (ValueError, KeyError) as e:
                self._send(f"bad request: {e}", 400)
                return
            except Exception as e:  # noqa: BLE001 — backend fault → 500
                self._send(f"synthesis failed: {type(e).__name__}: {e}", 500)
                return

            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Connection", "close")
            self.end_headers()

            def _pcm(chunk) -> bytes:
                return (np.clip(chunk, -1.0, 1.0) * 32767.0).astype("<i2").tobytes()

            try:
                self.wfile.write(_wav_stream_header(SAMPLE_RATE))
                if first_chunk is not None:
                    self.wfile.write(_pcm(first_chunk))
                for chunk in gen:
                    self.wfile.write(_pcm(chunk))
            except (BrokenPipeError, ConnectionResetError):
                pass  # client hung up mid-stream — normal for streaming
            except Exception:  # noqa: BLE001 — a later segment failed after
                # bytes flowed; the status is already on the wire, so the
                # only honest signal left is cutting the connection short
                pass

    return Handler


# the reference demo's pre-cached example sentences
EXAMPLE_TEXTS = (
    "We propose Matcha TTS, a new approach to non autoregressive neural text to speech.",
    "The Secret Service believed that it was very doubtful that any President would ride regularly in a vehicle with a fixed top, even though transparent.",
)


def cache_examples(models, texts, spk: int, steps: int, seed: int = 0) -> str:
    """Pre-render canonical example outputs per model at startup (the
    reference Gradio app's cache_examples=True): same
    text/seed across models, playable from the index page with zero
    request-time cost."""
    blocks = []
    for text in texts:
        for name, pl in models.items():
            try:
                res = pl.synthesise([text], spks=[spk], n_timesteps=steps,
                                    seed=seed, pcm16=True)[0]
            except Exception as e:  # noqa: BLE001 — an example must never
                # block serving (e.g. a text beyond the largest bucket)
                blocks.append(f'<div class="out"><p><b>{html.escape(name)}</b>: '
                              f"example failed: {html.escape(str(e))}</p></div>")
                continue
            title = f"{name}: {text[:60]}…" if len(text) > 60 else f"{name}: {text}"
            blocks.append(_render_result(res, title=title))
    return ("<h3>Cached examples</h3>" + "".join(blocks)) if blocks else ""


def serve(pipeline, host: str = "127.0.0.1", port: int = 7860, defaults=None,
          batching: bool = False, max_batch: int = 8, max_wait_ms: float = 10.0,
          extra_models=None, cache_example_texts=None):
    defaults = defaults or {"text": "Hey there! I am an emoji voice. 😎",
                            "steps": getattr(pipeline, "n_timesteps", 10),
                            "temperature": 0.667, "length_scale": 1.0, "spk": 79}
    engine = None
    if batching:
        from emojivoice_tpu_torch.inference.serving import BatchingEngine

        engine = BatchingEngine(pipeline, max_batch=max_batch, max_wait_ms=max_wait_ms)
    models = {"default": pipeline, **(extra_models or {})}
    examples_html = ""
    if cache_example_texts:
        examples_html = cache_examples(models, cache_example_texts,
                                       spk=int(defaults["spk"]),
                                       steps=int(defaults["steps"]))
    server = ThreadingHTTPServer(
        (host, port),
        make_handler(pipeline, defaults, engine, models=models,
                     examples_html=examples_html))
    server.engine = engine  # callers close it after shutdown()
    print(f"[webapp] serving on http://{host}:{server.server_address[1]}"
          + (f" (batching ≤{max_batch}/{max_wait_ms}ms)" if batching else "")
          + (f" models={list(models)}" if len(models) > 1 else ""))
    return server


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-tts-app-torch")
    p.add_argument("--checkpoint_path", default=None)
    p.add_argument("--vocoder", default=None)
    p.add_argument("--random_init", action="store_true")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--language", default=None, help="cleaning language (default: en)")
    p.add_argument("--model", action="append", default=None, metavar="NAME=CKPT[,VOCODER]",
                   help="load an ADDITIONAL named checkpoint for side-by-side "
                        "compare (repeatable); the reference demo serves two "
                        "models this way. NAME=random gives a "
                        "random-init model (demo without weights)")
    p.add_argument("--cache_examples", action="store_true",
                   help="pre-render the canonical example sentences per model "
                        "at startup (the reference's cache_examples=True)")
    p.add_argument("--batching", action="store_true",
                   help="coalesce concurrent requests into padded-batch calls")
    p.add_argument("--max_batch", type=int, default=8)
    p.add_argument("--max_wait_ms", type=float, default=10.0)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU instead of the CUDA device (same flag as emojivoice-tts-torch)")
    args = p.parse_args(argv)

    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.text.cleaners import LANGUAGE_CLEANERS

    device = "cpu" if args.cpu else "cuda"
    cleaners = (LANGUAGE_CLEANERS[args.language or "en"].__name__,)
    if args.random_init or not args.checkpoint_path:
        pipe = SynthesisPipeline.from_random(cleaners=cleaners, device=device)
    else:
        pipe = SynthesisPipeline.from_torch_checkpoints(
            args.checkpoint_path, args.vocoder, cleaners=cleaners, device=device)
    extra = {}
    for spec in args.model or ():
        if "=" not in spec:
            p.error(f"--model needs NAME=CKPT[,VOCODER], got {spec!r}")
        name, src = spec.split("=", 1)
        if name == "default" or name in extra:
            p.error(f"--model name {name!r} collides with "
                    + ("the primary model" if name == "default"
                       else "an earlier --model"))
        if src == "random":
            extra[name] = SynthesisPipeline.from_random(cleaners=cleaners, device=device)
        else:
            ckpt, _, voc = src.partition(",")
            extra[name] = SynthesisPipeline.from_torch_checkpoints(
                ckpt, voc or None, cleaners=cleaners, device=device)
    server = serve(pipe, args.host, args.port, batching=args.batching,
                   max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                   extra_models=extra or None,
                   cache_example_texts=EXAMPLE_TEXTS if args.cache_examples else None)
    try:
        server.serve_forever()
    finally:
        if server.engine is not None:
            server.engine.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
