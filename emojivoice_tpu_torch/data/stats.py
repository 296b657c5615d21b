"""`emojivoice-data-stats-torch`: a dataset's mel mean and standard deviation
(the port's copy of ``emojivoice_tpu.data.stats``, numpy only).

Streams a filelist with the statistics switched off (mean 0, std 1),
accumulates the global mel mean and std over all frames in float64, and
prints or writes the JSON that goes into the data config (or into
``training.train --mel_stats``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json


def compute_data_statistics(filelist: str, data_cfg) -> dict:
    import numpy as np

    from emojivoice_tpu_torch.config import DataStatistics
    from emojivoice_tpu_torch.data.dataset import TextMelDataset

    cfg = dataclasses.replace(data_cfg, data_statistics=DataStatistics(0.0, 1.0))
    ds = TextMelDataset(filelist, cfg)
    total = 0
    total_sum = 0.0
    total_sq = 0.0
    for i in range(len(ds)):
        mel = ds[i]["y"].astype(np.float64)
        total += mel.size
        total_sum += mel.sum()
        total_sq += (mel**2).sum()
    mean = total_sum / total
    std = float(np.sqrt(total_sq / total - mean**2))
    return {"mel_mean": float(mean), "mel_std": std}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="emojivoice-data-stats-torch")
    p.add_argument("--filelist", required=True, help="train filelist (path|spk|text)")
    p.add_argument("--preset", default="ljspeech")
    p.add_argument("--output", default=None, help="write JSON here (default: stdout)")
    args = p.parse_args(argv)

    from emojivoice_tpu_torch.config import get_preset

    stats = compute_data_statistics(args.filelist, get_preset(args.preset).data)
    out = json.dumps(stats, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(out)
    print(out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
