"""Profiling, debugging and logging utilities (PyTorch port of
``emojivoice_tpu.utils.observability``, the port's own copy).

* ``trace()`` records a ``torch.profiler`` trace (CPU, and CUDA activities
  when the work runs on the card) and writes it as a Chrome trace;
* ``enable_nan_checks()`` is ``torch.autograd.set_detect_anomaly``;
* ``seed_everything()`` seeds python, numpy and torch;
* ``is_main_process`` / ``main_process_only`` read the ``torch.distributed``
  rank (0 when no process group is up);
* ``TensorBoardWriter`` writes the ``scalars.jsonl`` sidecar always, a
  tensorboard event file only where the ``tensorboard`` package imports (as
  the JAX writer uses tensorflow only where it is), with tensorboard's protocol
  buffers and record framing and plain file I/O, never through TensorFlow,
  and a PNG per image where matplotlib imports; ``CSVLogger``, ``WandbLogger`` (gated by ``available()``),
  ``MultiLogger`` and ``make_logger`` are the JAX package's.  The jsonl, CSV
  and PNG files are the JAX writers' byte for byte for the same calls.
"""

from __future__ import annotations

import contextlib
import functools
import json
import logging
import os
import random as _random
import socket
import struct
import sys
import time
import zlib
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def seed_everything(seed: int) -> torch.Generator:
    """Seed python, numpy and torch's global generators and return a
    ``torch.Generator`` seeded with `seed` (the JAX copy returns a PRNGKey)."""
    _random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator().manual_seed(seed)


def enable_nan_checks(enable: bool = True):
    """Fail in the backward of the operation that made a NaN, with its
    forward traceback."""
    torch.autograd.set_detect_anomaly(enable)


def is_main_process() -> bool:
    dist = torch.distributed
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def main_process_only(fn):
    """Run fn only on rank 0 (the reference's rank_zero_only)."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_main_process():
            return fn(*args, **kwargs)
        return None

    return wrapper


def get_logger(name: str) -> logging.Logger:
    log = logging.getLogger(name)
    if not log.handlers and is_main_process():
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("[%(asctime)s][%(name)s][%(levelname)s] %(message)s"))
        log.addHandler(handler)
        log.setLevel(logging.INFO)
    return log


@contextlib.contextmanager
def trace(log_dir: str = "torch-trace", enabled: bool = True, device="cuda"):
    """Profile a block with ``torch.profiler`` and write
    ``<log_dir>/trace.json`` (chrome://tracing, Perfetto).  CUDA activities
    are recorded when `device` is a CUDA device."""
    if not enabled:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))


class StepTimer:
    """Wall-clock timer for steps; on a CUDA device each measurement waits for
    the device's queued work, so it counts the work, not its enqueue."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def measure(self, device=None):
        cuda = device is not None and torch.device(device).type == "cuda"
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        yield
        if cuda:
            torch.cuda.synchronize(device)
        self.times.append(time.perf_counter() - t0)

    def summary(self) -> dict:
        arr = np.asarray(self.times)
        if arr.size == 0:
            return {}
        return {"mean_s": float(arr.mean()), "median_s": float(np.median(arr)),
                "p90_s": float(np.percentile(arr, 90)), "n": int(arr.size)}


def _png(gray: np.ndarray) -> bytes:
    """(H, W) uint8 → an 8-bit greyscale PNG (zlib and struct only)."""
    def chunk(kind: bytes, data: bytes) -> bytes:
        return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)

    h, w = gray.shape
    raw = b"".join(b"\x00" + row.tobytes() for row in np.ascontiguousarray(gray, np.uint8))
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


class _EventFile:
    """A tensorboard event file (one ``Event`` protocol buffer a record, in
    tensorboard's ``RecordWriter`` framing) written with plain file I/O.
    ``torch.utils.tensorboard`` and tensorboard's own writers open their
    files through TensorFlow's gfile, which imports TensorFlow wherever it is
    installed (and with it, in some images, JAX); this needs the
    ``tensorboard`` package alone, and raises ImportError without it."""

    def __init__(self, log_dir: Path):
        from tensorboard.compat.proto.event_pb2 import Event  # noqa: PLC0415
        from tensorboard.compat.proto.summary_pb2 import Summary  # noqa: PLC0415
        from tensorboard.summary.writer.record_writer import RecordWriter  # noqa: PLC0415

        self._event, self._summary = Event, Summary
        name = f"events.out.tfevents.{int(time.time())}.{socket.gethostname()}.{os.getpid()}.0"
        self._records = RecordWriter(open(log_dir / name, "wb"))
        self._write(file_version="brain.Event:2")

    def _write(self, **fields):
        self._records.write(self._event(wall_time=time.time(), **fields).SerializeToString())

    def scalar(self, tag: str, value: float, step: int):
        self._write(step=step, summary=self._summary(value=[self._summary.Value(tag=tag, simple_value=value)]))

    def image(self, tag: str, gray: np.ndarray, step: int):
        h, w = gray.shape
        img = self._summary.Image(height=h, width=w, colorspace=1, encoded_image_string=_png(gray))
        self._write(step=step, summary=self._summary(value=[self._summary.Value(tag=tag, image=img)]))

    def flush(self):
        self._records.flush()

    def close(self):
        self._records.close()


class TensorBoardWriter:
    """Scalar/image logging: tensorboard event files where the
    ``tensorboard`` package imports, and a jsonl sidecar always."""

    def __init__(self, log_dir: str):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.jsonl = self.log_dir / "scalars.jsonl"
        try:
            self._events = _EventFile(self.log_dir)
        except ImportError:  # no tensorboard: the jsonl sidecar alone
            self._events = None

    @property
    def event_files(self) -> bool:
        """Whether a tensorboard event file is being written."""
        return self._events is not None

    def scalar(self, tag: str, value: float, step: int):
        with open(self.jsonl, "a") as f:
            f.write(json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n")
        if self._events is not None:
            self._events.scalar(tag, float(value), int(step))

    def image(self, tag: str, image_hwc: np.ndarray, step: int):
        """image_hwc: (H, W) or (H, W, C) float array."""
        img = np.asarray(image_hwc)
        if img.size == 0:
            # a degenerate render (zero predicted frames early in training) must not stop the training loop
            return
        if img.ndim == 2:
            img = img[..., None]
        path = self.log_dir / f"{tag.replace('/', '_')}_{step}.png"
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(10, 3))
            ax.imshow(img[..., 0], aspect="auto", origin="lower", interpolation="none")
            fig.tight_layout()
            fig.savefig(path)
            plt.close(fig)
        except Exception:  # noqa: BLE001
            pass
        if self._events is not None:
            norm = (img[..., 0] - img.min()) / (np.ptp(img) + 1e-9)
            self._events.image(tag, np.round(norm * 255.0).astype(np.uint8), int(step))

    def flush(self):
        if self._events is not None:
            self._events.flush()

    def close(self):
        """Flush and close the event file."""
        if self._events is not None:
            self._events.close()
            self._events = None


class CSVLogger:
    """Lightning-CSVLogger-shaped metrics file: one wide ``metrics.csv`` with
    a ``step`` column plus one column per metric tag, a row per logged step.

    Rows are appended on flush; the file is rewritten only when a tag that
    appears late (val/*, probe/*) widens the header.  Metrics logged for a
    step after that step's row reached the disk land on another row for the
    same step (readers group by the step column, as Lightning's do).
    """

    def __init__(self, log_dir: str):
        self.path = Path(log_dir) / "metrics.csv"
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._pending: dict[int, dict] = {}
        self._tags: list[str] = []
        self._header_tags: list[str] = []  # tags in the on-disk header

    def scalar(self, tag: str, value: float, step: int):
        if tag not in self._tags:
            self._tags.append(tag)
        self._pending.setdefault(int(step), {})[tag] = float(value)

    def image(self, tag: str, image_hwc, step: int):
        pass  # CSV carries scalars only (Lightning's does the same)

    def flush(self):
        import csv

        if not self._pending and self._tags == self._header_tags:
            return
        fields = ["step"] + self._tags
        if self._tags != self._header_tags:
            # header changed: (re)write it, carrying already-flushed rows over
            old_rows = []
            if self._header_tags and self.path.exists():
                with open(self.path, newline="") as f:
                    old_rows = list(csv.DictReader(f))
            with open(self.path, "w", newline="") as f:
                w = csv.DictWriter(f, fieldnames=fields)
                w.writeheader()
                for row in old_rows:
                    w.writerow({k: v for k, v in row.items() if v not in (None, "")})
            self._header_tags = list(self._tags)
        with open(self.path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=fields)
            for step in sorted(self._pending):
                w.writerow({"step": step, **self._pending[step]})
        self._pending.clear()

    def close(self):
        self.flush()


class WandbLogger:
    """Weights & Biases adapter, gated on the ``wandb`` package: without it
    construction raises ImportError (``make_logger`` skips it with a warning
    instead)."""

    @staticmethod
    def available() -> bool:
        try:
            import wandb  # noqa: F401, PLC0415

            return True
        except ImportError:
            return False

    def __init__(self, log_dir: str, project: str = "emojivoice-tpu", name: Optional[str] = None, **init_kw):
        import wandb  # raises ImportError when absent: the factory gates

        self._wandb = wandb
        self._run = wandb.init(project=project, name=name, dir=log_dir, **init_kw)

    def scalar(self, tag: str, value: float, step: int):
        self._run.log({tag: float(value)}, step=int(step))

    def image(self, tag: str, image_hwc, step: int):
        img = np.asarray(image_hwc)
        if img.size == 0:
            return
        self._run.log({tag: self._wandb.Image(img)}, step=int(step))

    def flush(self):
        pass  # wandb streams asynchronously

    def close(self):
        self._run.finish()


class MultiLogger:
    """Fan-out over several scalar/image writers (the reference's
    ``logger: many_loggers``)."""

    def __init__(self, writers):
        self.writers = list(writers)

    def scalar(self, tag, value, step):
        for w in self.writers:
            w.scalar(tag, value, step)

    def image(self, tag, image_hwc, step):
        for w in self.writers:
            w.image(tag, image_hwc, step)

    def flush(self):
        for w in self.writers:
            w.flush()

    def close(self):
        for w in self.writers:
            w.close()


LOGGER_BACKENDS = ("tensorboard", "csv", "wandb")


def make_logger(kinds: str, log_dir: str):
    """A (possibly composite) metrics writer from a comma list.  An
    unavailable backend (wandb without the package) is skipped with a warning
    on stderr; with none left, the tensorboard writer (which still writes its
    jsonl sidecar)."""
    writers = []
    for kind in [k.strip().lower() for k in kinds.split(",") if k.strip()]:
        if kind in ("tensorboard", "tb"):
            writers.append(TensorBoardWriter(log_dir))
        elif kind == "csv":
            writers.append(CSVLogger(log_dir))
        elif kind == "wandb":
            if WandbLogger.available():
                writers.append(WandbLogger(log_dir))
            else:
                print("[observability] wandb requested but not installed — skipping that backend", file=sys.stderr)
        else:
            raise ValueError(f"unknown logger backend {kind!r}; available: {LOGGER_BACKENDS}")
    if not writers:  # "wandb" alone without the package
        writers.append(TensorBoardWriter(log_dir))
    return writers[0] if len(writers) == 1 else MultiLogger(writers)
