"""K3's share of its roofline over the traced slice: the least time the card
could take for the slice's routed-expert work (``work_moe.bound_s`` of the
prefills' routing counts and the decode steps drivers/agent_moe.py recorded over the
slice) over K3's device time by kernel name, percent; nothing where the
program keeps no MoE counters or no K3 kernel ran."""

from benchmark import work_moe
from benchmark.configs.agent_whisper_dsv2lite import llm_config

K3_KERNELS = ("k3_",)


def read(record):
    t, counts = record.trace, record.extra.get("moe_slice")
    if t is None or not counts:
        return None
    k3_s = t.kernel_s(*K3_KERNELS)
    if k3_s <= 0:
        return None
    return 100.0 * work_moe.bound_s(llm_config(record.extra["config"]), counts) / k3_s
