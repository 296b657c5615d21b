"""`emojivoice-export-torch-torch`: a trained run's model as one
reference-format checkpoint file (PyTorch port of
``emojivoice_tpu.io.export_torch``).

    python -m emojivoice_tpu_torch.io.export_torch --ckpt_dir logs/run/ckpts --output voice.ckpt

The port's parameter names and layouts already are the reference's, so this
reads a step of the trainer's ``ckpts/`` directory and writes ``{"state_dict":
model state dict, "hyper_parameters": plain dicts}``: what
``io.torch_ckpt.load_matcha``, ``SynthesisPipeline.from_torch_checkpoints``,
``training.train --from_torch_ckpt`` and reference-side tooling read.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional


def export(ckpt_dir: str, output: str, step: Optional[int] = None) -> Path:
    import torch

    from emojivoice_tpu_torch.io.checkpoint import CheckpointManager
    from emojivoice_tpu_torch.io.torch_ckpt import matcha_hyper_parameters

    mgr = CheckpointManager(ckpt_dir)
    cfg = mgr.load_config()
    restored = mgr.restore(step)
    sd = restored["model"] if "model" in restored else restored
    out = Path(output)
    torch.save({"state_dict": {k: v.detach().cpu().contiguous() for k, v in sd.items()},
                "hyper_parameters": matcha_hyper_parameters(cfg.model)}, out)
    print(f"wrote torch checkpoint: {out} ({len(sd)} tensors)")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-export-torch-torch")
    p.add_argument("--ckpt_dir", required=True, help="the trainer's checkpoint directory (out_dir/ckpts)")
    p.add_argument("--output", required=True, help="output .ckpt path")
    p.add_argument("--step", type=int, default=None)
    args = p.parse_args(argv)
    export(args.ckpt_dir, args.output, args.step)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
