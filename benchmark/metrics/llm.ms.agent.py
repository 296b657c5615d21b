"""The chat LM's reply, host clock around ``TorchChatLM.chat``, mean per
turn, milliseconds."""


def read(record):
    spans = record.spans.named("llm.chat")
    return 1e3 * sum(s.t1 - s.t0 for s in spans) / len(spans) if spans else None
