"""matcha_emoji_v1: the port's synthesis pipeline at the configuration's
sizes, with weights drawn on the card from the run's seed.

``build`` makes the system under test; ``reference_weights`` draws the same
weights again for the reference after the system has been freed.
"""

from __future__ import annotations

import dataclasses
import math
import random

import numpy as np
import torch

from benchmark.reference import matcha as ref
from benchmark.traffic.generate import EMOJI_SPEAKERS, reply_text, sub_seed
from benchmark.weights import draw


def _root(cfg: dict):
    from emojivoice_tpu_torch import config as C

    return C.RootConfig(model=C.from_dict(C.ModelConfig, cfg["model"]),
                        vocoder=C.from_dict(C.HiFiGANConfig, cfg["vocoder"]))


def _calibrate(cfg: dict, sd: dict) -> float:
    """The duration head's bias shifted to the configuration's speaking rate
    (``reference/matcha.py::calibrate_durations``) on texts fixed by the
    configuration."""
    c = cfg["durations"]
    rng = random.Random(c["base_seed"])
    texts = [reply_text(rng, n, max(1, n // 60)) for n in c["text_chars"]]
    speakers = list(EMOJI_SPEAKERS.values())  # most frequent first, weighted as the traffic's Zipf skew
    weights = [1.0 / (k + 1) ** c["zipf_s"] for k in range(len(speakers))]
    frame_rate = cfg["vocoder"]["sampling_rate"] / math.prod(cfg["vocoder"]["upsample_rates"])
    return ref.calibrate_durations(sd, cfg["model"], texts, speakers, weights, c["chars_per_s"], frame_rate)


def reference_weights(cfg: dict, seed: int, device, which: str = "tts") -> tuple:
    """(Matcha-TTS state dict, HiFi-GAN state dict) of the run's seed."""
    sd = draw(ref.matcha_spec(cfg["model"], cfg["speaker_emb_std"]), sub_seed(seed, "matcha"), device)
    with torch.no_grad():
        _calibrate(cfg, sd)
    return sd, draw(ref.hifigan_spec(cfg["vocoder"]), sub_seed(seed, "hifigan"), device)


@dataclasses.dataclass
class Synthesis:
    cfg: dict
    pipe: object

    @property
    def synth(self) -> dict:
        return self.cfg["synthesis"]

    def call_kw(self, **over) -> dict:
        s = self.synth
        kw = dict(n_timesteps=s["n_timesteps"], temperature=s["temperature"], length_scale=s["length_scale"],
                  denoiser_strength=s["denoiser_strength"], pcm16=s["pcm16"], keep_mel=False)
        kw.update(over)
        return kw

    def lengths(self, texts, spks, length_scale: float, chunk: int = 64) -> list:
        """(text bucket, predicted mel frames) of each text at batch 1: the
        pipeline's own front end and stage A, in chunks."""
        from emojivoice_tpu_torch.inference.pipeline import upload
        from emojivoice_tpu_torch.utils.buckets import pick_bucket

        out = []
        pipe = self.pipe
        for i in range(0, len(texts), chunk):
            x, xl, _, _ = pipe.encode_texts(texts[i:i + chunk])
            spk = upload(torch.as_tensor(np.asarray(spks[i:i + chunk], np.int64)), pipe.device)
            with torch.no_grad():
                y = pipe.model.encode_text(upload(torch.from_numpy(x), pipe.device),
                                           upload(torch.from_numpy(xl), pipe.device), spk, length_scale)[2]
            out += [(pick_bucket(int(n), pipe.text_buckets), int(m)) for n, m in zip(xl, y.cpu().tolist())]
        return out

    def warm(self, keys, batch: int, **kw) -> None:
        """Capture the graphs of each (text bucket, mel bucket) of `keys` at
        `batch` rows: one fused call with the mel bucket given, which runs
        the stage keys a two-stage call at these buckets runs."""
        for t_bucket, m_bucket in sorted(keys):
            text = " ".join(["ab"] * ((t_bucket - 1) // 6))  # 'ab' + ' ' is three symbols, six interspersed ids
            self.pipe.synthesise([text] * batch, spks=[0] * batch, seed=0, fused=True, fused_mel_bucket=m_bucket,
                                 **self.call_kw(**kw))

    def free(self) -> None:
        self.pipe = None


def build(cfg: dict, seed: int, device) -> Synthesis:
    """The pipeline through captured graphs (its default on the card), its
    modules made on `device` and their weights drawn there from the seed."""
    from emojivoice_tpu_torch.inference.pipeline import SynthesisPipeline
    from emojivoice_tpu_torch.models.matcha import MatchaTTS
    from emojivoice_tpu_torch.vocoder.hifigan import HiFiGANGenerator

    root = _root(cfg)
    s = cfg["synthesis"]
    with torch.device(device):
        model, vocoder = MatchaTTS(root.model), HiFiGANGenerator(root.vocoder)
    for module, spec, purpose in ((model, ref.matcha_spec(cfg["model"], cfg["speaker_emb_std"]), "matcha"),
                                  (vocoder, ref.hifigan_spec(cfg["vocoder"]), "hifigan")):
        params = dict(module.named_parameters())
        diff = set(n for n, _, _ in spec) ^ set(params)
        if diff:
            raise RuntimeError(f"matcha_emoji_v1: the weight spec and the program's parameters differ: {sorted(diff)}")
        draw(spec, sub_seed(seed, purpose), device, out=params)
        if purpose == "matcha":
            with torch.no_grad():
                _calibrate(cfg, params)
    pipe = SynthesisPipeline(root.model, model, root.vocoder, vocoder, device=device, graphs=True,
                             text_buckets=s["text_buckets"], mel_buckets=s["mel_buckets"],
                             cleaners=tuple(s["cleaners"]), denoiser_mode=s["denoiser_mode"])
    return Synthesis(cfg=cfg, pipe=pipe)
