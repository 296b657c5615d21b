"""The chat LM's reply (DeepSeek-V2-Lite), host clock around
``TorchChatLM.chat``, mean per turn, milliseconds: ``llm.ms.agent``'s
reader."""

from pathlib import Path

from benchmark.harness import load_module

read = load_module(Path(__file__).with_name("llm.ms.agent.py"), "metric_llm.ms.agent").read
