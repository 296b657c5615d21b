"""The port's entry points run on the card unless the caller asks for the CPU:
without a CUDA device they raise and name ``device="cpu"``; they never carry
on on the CPU by themselves."""

import pytest
import torch

from emojivoice_tpu_torch import config as cfglib
from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
from emojivoice_tpu_torch.models.matcha import MatchaTTS
from emojivoice_tpu_torch.training.state import create_train_state
from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

VOC = cfglib.HiFiGANConfig(upsample_rates=(4, 4), upsample_kernel_sizes=(8, 8), upsample_initial_channel=32,
                           resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 3), (1, 3)))


def _root():
    return cfglib.RootConfig(model=cfglib.tiny().model, vocoder=VOC)


def _state_dicts(root):
    return MatchaTTS(root.model).state_dict(), HiFiGANGenerator(root.vocoder).state_dict()


def _from_random(**kw):
    return SynthesisPipeline.from_random(_root(), seed=0, **kw)


def _from_state_dicts(**kw):
    root = _root()
    matcha_sd, hifigan_sd = _state_dicts(root)
    return SynthesisPipeline.from_state_dicts(root.model, matcha_sd, root.vocoder, hifigan_sd, **kw)


def _init(**kw):
    root = _root()
    return SynthesisPipeline(root.model, MatchaTTS(root.model), root.vocoder, HiFiGANGenerator(root.vocoder), **kw)


def _train_state(**kw):
    root = cfglib.tiny()
    return create_train_state(root.model, root.optimizer, seed=0, **kw)


ENTRY_POINTS = {"from_random": _from_random, "from_state_dicts": _from_state_dicts, "__init__": _init,
                "create_train_state": _train_state}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_without_a_card_raises_and_names_the_cpu(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_runs_on_the_cpu_when_asked(name):
    made = ENTRY_POINTS[name](device="cpu")
    assert made.device.type == "cpu"
    assert all(p.device.type == "cpu" for p in made.model.parameters())


def test_pipeline_on_the_cpu_synthesises():
    pipe = _from_random(device="cpu", mel_buckets=(64, 128, 256), text_buckets=(64, 128))
    res = pipe.synthesise(["asked for the cpu"], spks=[1], n_timesteps=2, seed=0)[0]
    assert res.mel_length > 0 and res.wav.shape == (res.mel_length * 16,)
