"""Closed-loop agent sessions: per turn the recording is transcribed
(``TorchWhisperASR.transcribe``) and ``FeelMe.turn`` answers it (the chat
LM's reply, the emoji's voice, the pipelined synthesis into a sink that
does not block).  A new ``FeelMe`` starts each session, so its history grows
through the session's turns.  Every ``greedy_every``-th session speaks
through the greedy chat adapter, the others through the sampled one.

A turn's first audio runs from the end of the recording (the call to
``transcribe``) to its first chunk at the sink.  The window runs whole turns:
the turn in progress at its end is finished.  Set-up runs the traffic's warm
session through both chat adapters and captures the synthesis keys that
spoken segments reach: each text bucket up to the segment length's with each
mel bucket up to the longest those segments are predicted to take.
"""

from __future__ import annotations

import os
import random
import tempfile
import time
import wave

import numpy as np

from benchmark.checks import agent as agent_check
from benchmark.checks import tts as tts_check
from benchmark.harness import Record, Slice, Spans, span_label
from benchmark.traffic.generate import EMOJI_SPEAKERS, reply_text, sub_seed


class Sink:
    """Takes the played chunks without waiting for them to sound."""

    def __init__(self):
        self.first = None
        self.chunks = []

    def play(self, wav, sample_rate: int) -> None:
        if self.first is None:
            self.first = time.perf_counter()
        self.chunks.append(wav)


class Recorder:
    def record(self, path: str) -> bool:
        return True


class TimedChat:
    """The chat adapter behind a span of the benchmark's."""

    def __init__(self, llm, spans: Spans):
        self.llm, self.spans = llm, spans

    def chat(self, *a):
        return self.spans.timed("llm.chat", self.llm.chat, *a)


class Driver:
    def __init__(self, cell: dict, system, traffic: dict, device, seed: int):
        self.cell, self.sys, self.traffic, self.device = cell, system, traffic, device
        self.check_seed = sub_seed(seed, "check")
        self.tmp = tempfile.mkdtemp(prefix="bench_agent_")

    def _path(self, s: int, k: int, wav: np.ndarray) -> str:
        path = os.path.join(self.tmp, f"s{s}_t{k}.wav")
        if not os.path.exists(path):
            with wave.open(path, "wb") as f:
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(self.traffic["sample_rate"])
                f.writeframes((np.clip(wav, -1, 1) * 32767).astype(np.int16).tobytes())
        return path

    def _app(self, llm, sink, spans):
        from emojivoice_tpu_torch.apps.feel_me import FeelMe

        a = self.sys.cfg["agent"]
        return FeelMe(self.sys.synth.pipe, asr=self.sys.asr, llm=TimedChat(llm, spans), sink=sink,
                      recorder=Recorder(), steps=a["steps"], temperature=a["temperature"],
                      speaking_rate=a["speaking_rate"], denoiser_strength=a["denoiser_strength"],
                      pipelined=a["pipelined"], segment_chars=a["segment_chars"], voice=a["voice"])

    def warm(self) -> None:
        a = self.sys.cfg["agent"]
        syn = self.sys.synth
        t_max = next(t for t in syn.synth["text_buckets"] if t >= 2 * a["segment_chars"] + 1)
        rng = random.Random(self.check_seed)
        probe = [reply_text(rng, a["segment_chars"], 2) for _ in range(64)]
        spks = [rng.choice(list(EMOJI_SPEAKERS.values())) for _ in probe]
        longest = max(m for _, m in syn.lengths(probe, spks, a["speaking_rate"]))
        m_max = next((m for m in syn.synth["mel_buckets"] if m >= 1.25 * longest), syn.synth["mel_buckets"][-1])
        keys = {(t, m) for t in syn.synth["text_buckets"] if t <= t_max for m in syn.synth["mel_buckets"] if m <= m_max}
        syn.warm(keys, 1, pcm16=False, keep_mel=True, length_scale=a["speaking_rate"],
                 denoiser_strength=a["denoiser_strength"])
        for mode in ("sampled", "greedy"):
            app = self._app(self.sys.chat[mode], Sink(), Spans())
            for k, wav in enumerate(self.traffic["warm"][:3]):
                app.turn(self.sys.asr.transcribe(self._path(-1, k, wav)))

    def window(self, seconds: float, trace: bool) -> Record:
        spans = Spans()
        sl = Slice() if trace else None
        at, n_traced = self.cell["trace_at_turn"], self.cell["trace_turns"]
        every = self.traffic["greedy_every"]
        turns = []
        g0 = dict(asr=self.sys.asr.graphs.stats(), **{m: c.graphs.stats() for m, c in self.sys.chat.items()},
                  tts=self.sys.synth.pipe.graphs.stats())
        t_start = time.perf_counter()
        sessions = iter(enumerate(self.traffic["sessions"]))
        while time.perf_counter() - t_start < seconds:
            s, session = next(sessions)  # StopIteration: the traffic's sessions end before the window
            greedy = s % every == every - 1
            sink = Sink()
            app = self._app(self.sys.chat["greedy" if greedy else "sampled"], sink, spans)
            for k, wav in enumerate(session):
                if time.perf_counter() - t_start >= seconds:
                    break
                n = len(turns)
                path = self._path(s, k, wav)
                if sl is not None and n == at:
                    sl.start()
                sink.first, sink.chunks = None, []
                turn_seed = sub_seed(self.check_seed, f"turn{n}") % 2**32
                t0 = time.perf_counter()
                text = spans.timed("asr.transcribe", self.sys.asr.transcribe, path)
                t1 = time.perf_counter()
                np.random.seed(turn_seed)  # the pipeline draws each segment's noise seed from numpy's generator
                spans.timed("feel_me.turn", app.turn, text)
                t2 = time.perf_counter()
                if sl is not None and sl.active and n == at + n_traced - 1:
                    sl.stop()
                turns.append(dict(session=s, turn=k, greedy=greedy, wav=wav, t0=t0 - t_start, asr_s=t1 - t0,
                                  turn_s=t2 - t1, first_audio_s=(sink.first or t2) - t0, turn_seed=turn_seed,
                                  speech=np.concatenate(sink.chunks) if sink.chunks else np.zeros(0, np.float32),
                                  asr_ids=self.sys.asr_tok.decoded[-1], prompt_ids=self.sys.llm_tok.encoded[-1],
                                  reply_ids=self.sys.llm_tok.decoded[-1]))
        window_s = time.perf_counter() - t_start
        g1 = dict(asr=self.sys.asr.graphs.stats(), **{m: c.graphs.stats() for m, c in self.sys.chat.items()},
                  tts=self.sys.synth.pipe.graphs.stats())
        record = Record(cell=self.cell["name"], window_s=window_s, setup_s=0.0, items=turns, spans=spans,
                        counters=dict(before=g0, after=g1))
        for mode, greedy in (("greedy", True), ("sampled", False)):  # beside the metric: the two sessions' kinds
            ms = [1e3 * t["first_audio_s"] for t in turns if t["greedy"] == greedy]
            record.extra.setdefault("notes", {})[f"first_audio_ms.{mode}"] = sum(ms) / max(len(ms), 1)
        if sl is not None:
            record.trace = sl.reduce(span_label(spans, "host"))
        return record

    def close(self) -> None:
        import shutil

        shutil.rmtree(self.tmp, ignore_errors=True)

    def check(self, record: Record, weights_fn, control: bool = False) -> dict:
        """Every turn's tokens (some tens of turns) are judged: ``token_gap``,
        the widest of Whisper's and the chat LM's gaps; the speech of
        ``speech_turns`` of them drawn from the seed, the longest reply among
        them."""
        import torch

        turns = record.items
        w = weights_fn("whisper")
        asr, asr_low = agent_check.asr_gap(self.sys.cfg, w, turns, control)
        del w
        torch.cuda.empty_cache()
        w = weights_fn("gptj")
        llm, llm_low = agent_check.llm_gap(self.sys.cfg, w, turns, control)
        del w
        torch.cuda.empty_cache()
        judged = [turns[i] for i in tts_check.order(turns, self.check_seed,
                                                     key=lambda t: len(t["reply_ids"]))[: self.cell["speech_turns"]]]
        speech = agent_check.speech_err(self.sys.cfg, weights_fn("tts"), judged, self.device, control)
        extra = dict(control_token_gap=max(asr_low, llm_low), control_asr_gap=asr_low, control_llm_gap=llm_low) \
            if control else {}
        return {"token_gap": max(asr, llm), "asr_gap": asr, "llm_gap": llm, "judged": len(turns), **extra, **speech,
                "greedy_tokens": sum(len(t["reply_ids"]) for t in turns if t["greedy"]),
                "asr_tokens": sum(len(t["asr_ids"]) - 1 for t in turns)}


def outcome(record) -> tuple:
    """(turns of the window, none failed: a failure raises)."""
    return len(record.items), 0
