"""agent_turn_dsv2lite's sessions: ``drivers/agent.py``'s closed-loop turns
(Whisper, the chat LM, the pipelined synthesis), with a mixture-of-experts
chat LM.  Inside each turn, with no host read, it keeps device copies of the
scores the reply's first token was chosen from (``TorchChatLM.last_logits``
right after the prefill's graph ran: one copy a turn, taken in the chat
adapter's ``graphs.run``) and, after the reply, of the scores its last token
was chosen from and of the chat decoder's MoE counters
(``TorchChatLM.counters``), with the host's count of decode steps; they are
read after the window.  The record then holds, per turn, its first and last
scores (the check's ``llm_logit_err``) and its counters' change, and the
change over the window and over the traced slice
(``moe.load_imbalance.dsv2``, ``k3.roofline.dsv2``).  The check is
``checks/agent_moe.py``'s."""

from __future__ import annotations

from benchmark.checks import agent as agent_check
from benchmark.checks import agent_moe as moe_check
from benchmark.checks import tts as tts_check
from benchmark.drivers import agent as base

COUNTERS = ("pairs", "max_load", "hits")  # TorchChatLM.counters()' order


def keep_prefill_scores(llm) -> dict:
    """Wrap the chat adapter's ``graphs.run`` so that each prefill's scores
    are copied on the device as the graph finishes; the dict's ``"first"``
    holds the latest copy."""
    kept, run = {"first": None}, llm.graphs.run

    def run_(key, fn):
        run(key, fn)
        if key[0] == "prefill":
            kept["first"] = llm.last_logits()[-1:].clone()
    llm.graphs.run = run_
    return kept


class Kept:
    """The chat adapter, then what the turn's reply left on the device."""

    def __init__(self, chat, llm, mode: str, first: dict, kept: list):
        self.chat_, self.llm, self.mode, self.first, self.kept = chat, llm, mode, first, kept

    def chat(self, *a):
        reply = self.chat_.chat(*a)
        counters, steps = self.llm.counters()
        self.kept.append((self.mode, self.first["first"], self.llm.last_logits()[-1:].clone(),
                          None if counters is None else counters.clone(), steps))
        return reply


class Driver(base.Driver):
    def __init__(self, cell: dict, system, traffic: dict, device, seed: int):
        super().__init__(cell, system, traffic, device, seed)
        self.kept: list = []
        self.first = {mode: keep_prefill_scores(chat) for mode, chat in system.chat.items()}

    def _app(self, llm, sink, spans):
        app = super()._app(llm, sink, spans)
        mode = next(m for m, c in self.sys.chat.items() if c is llm)
        app.llm = Kept(app.llm, llm, mode, self.first[mode], self.kept)
        return app

    def _totals(self, snaps: dict) -> dict:
        out = dict.fromkeys(COUNTERS, 0)
        out["steps"] = 0
        for counters, steps in snaps.values():
            for name, v in zip(COUNTERS, counters):
                out[name] += v
            out["steps"] += steps
        return out

    def window(self, seconds: float, trace: bool):
        def snap(chat):
            counters, steps = chat.counters()
            return [int(v) for v in counters.tolist()] if counters is not None else [0, 0, 0], steps

        self.kept.clear()
        last = {m: snap(c) for m, c in self.sys.chat.items()}
        before = self._totals(last)
        record = super().window(seconds, trace)
        if len(self.kept) != len(record.items):
            raise RuntimeError(f"agent_moe: {len(self.kept)} replies kept for {len(record.items)} turns")
        for t, (mode, first, logits, counters, steps) in zip(record.items, self.kept):
            now = ([int(v) for v in counters.tolist()] if counters is not None else [0, 0, 0], steps)
            t["first_logits"], t["last_logits"] = first, logits
            t["moe"] = {name: a - b for name, a, b in zip(COUNTERS, now[0], last[mode][0])}
            t["moe"]["steps"] = now[1] - last[mode][1]
            last[mode] = now
        after = self._totals(last)
        record.counters["moe"] = dict(before=before, after=after)
        if record.trace is not None:
            at, n = self.cell["trace_at_turn"], self.cell["trace_turns"]
            traced = record.items[at: at + n]
            record.extra["moe_slice"] = {k: sum(t["moe"][k] for t in traced) for k in (*COUNTERS, "steps")}
            record.extra["moe_slice"]["prefills"] = len(traced)
        self.kept.clear()
        return record

    def check(self, record, weights_fn, control: bool = False) -> dict:
        """``drivers/agent.py``'s judgement of every turn with DeepSeek-V2's
        reference: ``token_gap`` the widest of Whisper's and the chat LM's
        gaps, ``llm_logit_err`` of each turn's first and last scores, and
        the speech of ``speech_turns`` turns (``checks/agent_moe.py``)."""
        import torch

        turns = record.items
        on_card = torch.device(self.device).type == "cuda"
        w = weights_fn("whisper")
        asr, asr_low = agent_check.asr_gap(self.sys.cfg, w, turns, control)
        del w
        if on_card:
            torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated() if on_card else 0  # what the freed system left before 63 GB are drawn
        w = weights_fn("llm")
        llm = moe_check.llm_gap(self.sys.cfg, w, turns, control)
        del w
        if on_card:
            torch.cuda.empty_cache()
        judged = [turns[i] for i in tts_check.order(turns, self.check_seed,
                                                     key=lambda t: len(t["reply_ids"]))[: self.cell["speech_turns"]]]
        speech = moe_check.speech_err(self.sys.cfg, weights_fn("tts"), judged, self.device, control)
        extra = dict(control_token_gap=max(asr_low, llm["control_llm_gap"]), control_asr_gap=asr_low) if control else {}
        return {"token_gap": max(asr, llm["llm_gap"]), "asr_gap": asr, "judged": len(turns), **llm, **extra, **speech,
                "check_held_bytes": held, "greedy_tokens": sum(len(t["reply_ids"]) for t in turns if t["greedy"]),
                "asr_tokens": sum(len(t["asr_ids"]) - 1 for t in turns)}


outcome = base.outcome
