"""The comparison that decides ``correct`` for the agent's turns with a
mixture-of-experts chat LM (agent_turn_dsv2lite): ``checks/agent.py``'s
Whisper gap and speech by import, and the chat LM held against DeepSeek-V2's
plain reference (``reference/deepseek_v2.py``).

For each turn the reference runs once over the prompt the chat LM was given
and its served reply (with the reply's eos where one ended it):

* ``llm_gap``: at every new token, how far the served token's logit lies
  below the best the rules allow — the best of all where greedy, the
  ``top_k``-th where sampled (``checks/agent.py``'s reading);
* ``llm_logit_err``: at two positions of each turn, the largest difference
  between the scores the chat decoder chose a token from and the
  reference's logits there, over the reference row's largest magnitude:
  the first new token's (the prefill's scores, through K3's grouped GEMM)
  and the last one's (a decode step's, through K3's GEMVs over a cache the
  prefill wrote), both device copies drivers/agent_moe.py keeps.
  ``llm_logit_err_first`` is the prefill's part of it (not limited apart).
  ``token_gap`` cannot tell float32 from TF32 in this cell (PERF.md §2): a
  TF32 K3 would choose the same tokens.

A router near-tie: at a compared position, the reference's 6th and 7th
router scores (``num_experts_per_tok``-th and the next) lie closer than
``ROUTER_TIE`` of the 6th in some MoE layer.  There the program and the
reference, both sound, may route one expert differently (their hidden
states differ by f32 rounding, ~1e-5 of their size), which moves that
position's logits by about 1e-2, as TF32 does.  Such a position's
``llm_logit_err`` is not read; it is counted in ``llm_router_ties``, which
the cell caps from the sound runs' readings, as the serving check skips
duration ties.  ``llm_router_gap`` is the smallest relative gap of the
positions read.

With ``control``, the same readings of the reference in TF32 at the same
positions (``control_llm_gap``, ``control_llm_logit_err``).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.checks import agent as agent_check
from benchmark.configs.agent_whisper_dsv2lite import llm_config
from benchmark.reference import deepseek_v2 as ref
from benchmark.reference.precision import tf32

# a relative gap of the 6th and 7th router scores under this is a near-tie: ten times the relative drift of
# the program's hidden states from the reference's (llm_logit_err of sound runs, 3e-5 to 2e-4; PERF.md)
ROUTER_TIE = 1e-4


def logit_err(served: torch.Tensor, want: torch.Tensor) -> float:
    """max |served − want| over the entries the rules left finite, over
    max |want|."""
    served = served.to(want.device).float().view(-1)
    live = torch.isfinite(served)
    return float((served[live] - want[live]).abs().max() / want.abs().max())


def llm_gap(cfg: dict, sd: dict, turns: list, control: bool = False) -> dict:
    """The chat LM's readings over `turns` (the module docstring)."""
    llm, gen = llm_config(cfg), cfg["llm_generation"]
    top_k, k = gen["top_k"], llm["num_experts_per_tok"]
    out = dict(llm_gap=0.0, llm_logit_err=0.0, llm_logit_err_first=0.0, llm_router_ties=0,
               llm_router_gap=float("inf"))
    read = []  # (llm_logit_err, router gap, position's name) of each position read
    if control:
        out.update(control_llm_gap=0.0, control_llm_logit_err=0.0)
    for t in turns:
        prompt, reply = t["prompt_ids"], t["reply_ids"]
        ended = len(reply) < gen["max_new_tokens"]  # eos chose the last token: its scores follow the reply
        ids = prompt + (reply if ended else reply[:-1])
        first, kth = len(prompt) - 1, 1 if t["greedy"] else top_k
        scores: list = []
        x = ref.logits(sd, llm, ids, first=first, gate_scores=scores)
        if reply:
            out["llm_gap"] = max(out["llm_gap"], float(agent_check._gap(x[: len(reply)], reply, kth).max()))
        low = None
        if control:
            with tf32(True):
                low = ref.logits(sd, llm, ids, first=first)
            if reply:
                out["control_llm_gap"] = max(out["control_llm_gap"],
                                             float(agent_check._gap(x[: len(reply)], low[: len(reply)].argmax(-1)
                                                                    .tolist(), kth).max()))
        # the prefill's position, then the last token's (one position where the reply is its first token)
        compared = {0: ("first", t["first_logits"]), x.shape[0] - 1: ("last", t["last_logits"])}
        for row, (name, served) in compared.items():
            ranked = torch.stack([s[first + row] for s in scores])  # (MoE layers, E) sorted
            gap = float(((ranked[:, k - 1] - ranked[:, k]) / ranked[:, k - 1]).min()) if scores else float("inf")
            if gap < ROUTER_TIE:
                out["llm_router_ties"] += 1
                continue
            err = logit_err(served, x[row])
            read.append((err, gap, name))
            out["llm_logit_err"] = max(out["llm_logit_err"], err)
            if name == "first":
                out["llm_logit_err_first"] = max(out["llm_logit_err_first"], err)
            out["llm_router_gap"] = min(out["llm_router_gap"], gap)
            if control:
                out["control_llm_logit_err"] = max(out["control_llm_logit_err"], logit_err(low[row], x[row]))
    out["llm_logit_err_top"] = sorted(read, reverse=True)[:4]
    if control:
        out["control_llm_router_ties"] = out["llm_router_ties"]  # the same positions are read
    return out


def _spoken(special: int):
    """``checks/agent.py``'s ``_spoken`` with the stub's special ids from
    `special` on."""
    def spoken(reply_ids: list, word, mapping: dict) -> tuple:
        words = [word(i) for i in reply_ids if 2 < i < special]
        response = " ".join(words).strip()
        spk = next((mapping[c] for c in response if c in mapping), 0)
        text = "".join(c for c in response if c not in mapping).replace(")", "").replace("(", "").strip()
        return spk, text or "nice"
    return spoken


@contextlib.contextmanager
def _special(special: int):
    real = agent_check._spoken
    agent_check._spoken = _spoken(special)
    try:
        yield
    finally:
        agent_check._spoken = real


def speech_err(cfg: dict, weights: tuple, turns: list, device, control: bool = False) -> dict:
    """``checks/agent.py``'s ``speech_err``, the reply's words read with the
    chat LM's special boundary (its ``bos_token_id``)."""
    with _special(llm_config(cfg)["bos_token_id"]):
        return agent_check.speech_err(cfg, weights, turns, device, control)
