"""The traffic generator: the same seed gives the same traffic, another seed
other content with the same sizes, gaps and voices, and the lengths and skew
are those the mixes state."""

from __future__ import annotations

import collections

import numpy as np

from benchmark.traffic import generate as G


def test_same_seed_same_traffic_other_seed_other_words():
    a, b, c = (G.make("poisson_replies", s, 20) for s in (2**31 + 3, 2**31 + 3, 2**31 + 4))
    assert a["requests"] == b["requests"]
    assert [r["text"] for r in a["requests"]] != [r["text"] for r in c["requests"]]
    assert [(r["due"], r["chars"], r["spk"]) for r in a["requests"]] == \
        [(r["due"], r["chars"], r["spk"]) for r in c["requests"]]


def test_replies_lengths_rate_and_skew():
    mix = G.load("poisson_replies")
    t = G.make("poisson_replies", 11, 60)
    reqs = t["requests"]
    assert abs(len(reqs) / 60 - mix["arrivals"]["rate_per_s"]) < 0.15 * mix["arrivals"]["rate_per_s"]
    lo, hi = mix["chars"]
    assert all(lo <= r["chars"] <= hi for r in reqs)
    # whole words: a reply comes out up to 20 characters under its target length, and over it by its emoji at most
    assert all(r["chars"] - 20 <= len(r["text"]) <= r["chars"] + 2 for r in reqs)
    counts = collections.Counter(r["spk"] for r in reqs)
    ids = list(G.EMOJI_SPEAKERS.values())
    assert set(counts) <= set(ids)
    assert counts[ids[0]] > 2 * counts[ids[-1]]  # Zipf: the first voice well above the last
    assert all(set(r["text"].lower()) - set("abcdefghijklmnopqrstuvwxyz ,.!?") <= set(G.EMOJI_SPEAKERS)
               for r in reqs)


def test_story_segments_and_sessions():
    s = G.make("story_batches", 5, 10)
    assert all(len(b["texts"]) == 32 for b in s["batches"])
    lens = [len(t) for b in s["batches"] for t in b["texts"]]
    assert 120 <= min(lens) and max(lens) <= 200
    a = G.make("agent_sessions", 5, 10)
    mix = G.load("agent_sessions")
    assert len(a["sessions"]) == mix["sessions"] and all(len(x) == mix["turns"] for x in a["sessions"])
    durs = [len(w) / mix["sample_rate"] for x in a["sessions"] for w in x]
    assert 2.0 <= min(durs) and max(durs) <= 6.0
    b = G.make("agent_sessions", 6, 10)
    assert not np.array_equal(a["sessions"][0][0], b["sessions"][0][0])
    assert [len(w) for w in a["sessions"][0]] == [len(w) for w in b["sessions"][0]]


def test_split_text_is_the_programs():
    from emojivoice_tpu_torch.inference.longform import split_text

    for seed in range(5):
        text = G.reply_text(__import__("random").Random(seed), 700, 9)
        assert G.split_text(text, 120) == split_text(text, 120)
