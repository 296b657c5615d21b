"""The routing's load imbalance over the window's prefills: the pairs of the
busiest expert summed over each prefill's MoE layers, over the pairs
summed alike and divided by the experts (the busiest expert's load against
an even one; 1 is even).  From the chat decoders' counters, read before and
after the window; nothing where the program keeps none."""

from benchmark.configs.agent_whisper_dsv2lite import llm_config


def read(record):
    moe = record.counters.get("moe")
    if not moe:
        return None
    pairs = moe["after"]["pairs"] - moe["before"]["pairs"]
    busiest = moe["after"]["max_load"] - moe["before"]["max_load"]
    experts = llm_config(record.extra["config"])["n_routed_experts"]
    return busiest / (pairs / experts) if pairs else None
