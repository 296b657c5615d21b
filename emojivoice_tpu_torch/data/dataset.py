"""Text+mel dataset with static-bucket batching (the port's copy of
``emojivoice_tpu.data.dataset``, numpy only).

Behavioral equivalent of the reference datamodule
(reference: Matcha-TTS/matcha/data/text_mel_datamodule.py): filelists of
``path|spk|text`` (multi-speaker) or ``path|text``, per-item text→ids with
interspersed blanks, wav→log-mel, normalization by dataset stats, optional
precomputed durations from ``durations/<name>.npy``.

Departures kept from the JAX package:

* collate pads to **static buckets** (text and mel), not the batch max, so
  that shapes come from a small fixed set (the keys of a later CUDA-graph
  cache, and the same batches as the JAX trainer's); the reference's
  pad-to-multiple-of-4 (fix_len_compatibility) is subsumed because buckets
  are multiples of 4;
* batches are plain numpy dicts;
* a background prefetch thread replaces torch DataLoader workers;
* ``process_shard=(data rank, data ranks)``: every rank walks the same
  global batch order and bucket choices (a header-only length scan,
  ``item_lengths``) but loads only its own rows of each batch, padded to an
  equal count with zero-weight rows (``row_mask``).  The ranks of one
  tensor-parallel group share a data rank and load the same rows.
"""

from __future__ import annotations

import random
import threading
from pathlib import Path
from queue import Full, Queue
from typing import Iterator, List, Optional, Sequence

import numpy as np

from emojivoice_tpu_torch.config import DataConfig
from emojivoice_tpu_torch.data.audio_np import load_wav, mel_spectrogram_np, resample_poly_np
from emojivoice_tpu_torch.text import text_to_sequence
from emojivoice_tpu_torch.utils.buckets import pick_bucket
from emojivoice_tpu_torch.utils.masks import intersperse


def parse_filelist(path: str, split_char: str = "|") -> List[List[str]]:
    """(reference: text_mel_datamodule.py:17-20)"""
    with open(path, encoding="utf-8") as f:
        return [line.strip().split(split_char) for line in f if line.strip()]


class TextMelDataset:
    def __init__(self, filelist_path: str, cfg: DataConfig, cache_items: bool = False):
        """cache_items: keep each decoded item (text ids + normalized mel) in
        memory after its first epoch.  The reference re-decodes the wav and
        recomputes the mel every epoch behind DataLoader worker processes
        (text_mel_datamodule.py:96-98,199-221).  Opt-in because it trades
        memory (~55 KB per 2 s utterance): right for 2-min-per-emoji
        fine-tune sets, wrong for LJSpeech-scale corpora (~2 GB)."""
        self.cfg = cfg
        self._cache: Optional[dict] = {} if cache_items else None
        entries = parse_filelist(filelist_path)
        self.items = []
        for e in entries:
            if cfg.n_spks > 1:
                path, spk, text = e[0], int(e[1]), e[2]
            else:
                path, spk, text = e[0], 0, e[1]
            self.items.append((path, spk, text))
        if cfg.n_spks > 1:
            # loud host-side check: on the card an out-of-range embedding
            # lookup is a device-side assert far from its cause
            bad = next(((p, s) for p, s, _ in self.items
                        if not 0 <= s < cfg.n_spks), None)
            if bad is not None:
                raise ValueError(
                    f"{filelist_path}: speaker id {bad[1]} for {bad[0]!r} is "
                    f"outside [0, {cfg.n_spks}) — fix the filelist or the "
                    f"preset's n_spks")
        rng = random.Random(cfg.seed)
        rng.shuffle(self.items)

    def __len__(self):
        return len(self.items)

    def _encode_text(self, text: str):
        """Single source of truth for the text path — item_lengths must
        agree with __getitem__ exactly (multi-process shape agreement)."""
        ids, cleaned = text_to_sequence(text, self.cfg.cleaners)
        if self.cfg.add_blank:
            ids = intersperse(ids, 0)
        return ids, cleaned

    def item_lengths(self, idx: int) -> tuple[int, int]:
        """(text_ids_len, mel_frames) WITHOUT decoding audio — used by the
        batcher's multi-process mode to agree on bucket shapes globally
        (every process must compile the same program for batch collectives
        to line up).  Text length comes from the cleaner alone; mel frames
        from the WAV header sample count and the exact STFT frame
        arithmetic of audio_np.mel_spectrogram_np.  Falls back to a full
        __getitem__ for non-native sample rates (resampler length is the
        resampler's business) or unparseable headers.  Pinned equal to
        __getitem__ in tests/test_dcn.py."""
        path, _, text = self.items[idx]
        x_len = len(self._encode_text(text)[0])
        a = self.cfg.audio
        try:
            from emojivoice_tpu_torch.data.audio_np import wav_info

            n, sr = wav_info(path)
        except Exception:  # noqa: BLE001 — odd container: decode instead
            sr = None
        if sr != a.sample_rate:
            it = self[idx]
            return len(it["x"]), it["y"].shape[0]
        pad = (a.n_fft - a.hop_length) // 2
        mel_len = 1 + (n + 2 * pad - a.n_fft) // a.hop_length
        return x_len, mel_len

    def __getitem__(self, idx: int) -> dict:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        path, spk, text = self.items[idx]
        ids, cleaned = self._encode_text(text)
        x = np.asarray(ids, np.int32)

        wav, sr = load_wav(path)
        if sr != self.cfg.audio.sample_rate:
            wav = resample_poly_np(wav, sr, self.cfg.audio.sample_rate)
        a = self.cfg.audio
        mel = mel_spectrogram_np(wav, a.n_fft, a.n_mels, a.sample_rate, a.hop_length,
                                 a.win_length, a.f_min, a.f_max)
        stats = self.cfg.data_statistics
        mel = (mel - stats.mel_mean) / stats.mel_std

        item = {"x": x, "y": mel, "spk": spk, "filepath": path, "cleaned_text": cleaned}
        if self.cfg.load_durations:
            dur_path = Path(path).parent.parent / "durations" / f"{Path(path).stem}.npy"
            durs = np.load(dur_path).astype(np.float32)
            assert len(durs) == len(x), f"{dur_path}: {len(durs)} durations vs {len(x)} tokens"
            item["durations"] = durs
        if self._cache is not None:
            self._cache[idx] = item
        return item


class BucketBatcher:
    """Group items into batches padded to static (text, mel) buckets."""

    def __init__(
        self,
        dataset: TextMelDataset,
        batch_size: int,
        text_buckets: Sequence[int] = (64, 128, 192, 256, 384, 512),
        mel_buckets: Sequence[int] = (128, 256, 384, 512, 768, 1024, 1536, 2048),
        min_mel_bucket: Optional[int] = None,
        shuffle: bool = True,
        seed: int = 1234,
        drop_last: bool = False,
        process_shard: Optional[tuple] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.text_buckets = tuple(text_buckets)
        self.mel_buckets = tuple(mel_buckets)
        # out_size training requires mel padding ≥ out_size
        self.min_mel_bucket = min_mel_bucket
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        # one-shot fast-forward: the next __iter__ skips this many leading
        # batches WITHOUT loading their audio (index arithmetic only) — the
        # training loop's data-order resume (a naive resume would replay the
        # epoch's already-seen batches)
        self.skip_next = 0
        # multi-process (DCN) mode: (process_id, process_count).  Every
        # process walks the SAME global batch order and bucket choices
        # (identical seed + a one-time length scan), but materializes only
        # its own row slice of each batch — the data-parallel IO split with
        # globally agreed XLA program shapes.
        self.process_shard = process_shard
        self._lengths = None
        if process_shard is not None:
            pid, pcount = process_shard
            if not (0 <= pid < pcount):
                raise ValueError(f"bad process_shard {process_shard}")
            if batch_size % pcount:
                raise ValueError(f"batch_size {batch_size} must divide by process count {pcount}")
            self._lengths = [dataset.item_lengths(j) for j in range(len(dataset))]

    def __iter__(self) -> Iterator[dict]:
        order = list(range(len(self.dataset)))
        if self.shuffle:
            random.Random(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        skip, self.skip_next = self.skip_next, 0
        for i in range(skip * self.batch_size, len(order), self.batch_size):
            idxs = order[i : i + self.batch_size]
            if self.drop_last and len(idxs) < self.batch_size:
                continue
            if self.process_shard is None:
                yield self.collate([self.dataset[j] for j in idxs])
            else:
                yield self._collate_process_shard(idxs)

    def _collate_process_shard(self, idxs: List[int]) -> dict:
        """One global batch, this process's rows only.

        Buckets come from the GLOBAL rows (via the length cache) so every
        process compiles identical shapes; the local slice is padded to
        exactly batch_size/process_count rows with zero-weight repeats
        ("row_mask"), so per-process shapes agree even on the uneven final
        batch and no data is dropped anywhere.
        """
        pid, pcount = self.process_shard
        tb = pick_bucket(max(self._lengths[j][0] for j in idxs), self.text_buckets)
        max_mel = max(self._lengths[j][1] for j in idxs)
        if self.min_mel_bucket is not None:
            max_mel = max(max_mel, self.min_mel_bucket)
        mb = pick_bucket(max_mel, self.mel_buckets)

        local = idxs[pid::pcount]
        b_local = self.batch_size // pcount
        n_real = len(local)
        local = (local + [local[-1] if local else idxs[0]] * b_local)[:b_local]
        batch = self.collate([self.dataset[j] for j in local], t_bucket=tb, m_bucket=mb)
        row_mask = np.zeros((b_local,), np.float32)
        row_mask[:n_real] = 1.0
        batch["row_mask"] = row_mask
        return batch

    def collate(self, items: List[dict], t_bucket: Optional[int] = None,
                m_bucket: Optional[int] = None) -> dict:
        b = len(items)
        tb = t_bucket or pick_bucket(max(len(it["x"]) for it in items), self.text_buckets)
        max_mel = max(it["y"].shape[0] for it in items)
        if self.min_mel_bucket is not None:
            max_mel = max(max_mel, self.min_mel_bucket)
        mb = m_bucket or pick_bucket(max_mel, self.mel_buckets)

        x = np.zeros((b, tb), np.int32)
        x_lengths = np.zeros((b,), np.int32)
        y = np.zeros((b, mb, items[0]["y"].shape[1]), np.float32)
        y_lengths = np.zeros((b,), np.int32)
        spks = np.zeros((b,), np.int32)
        durs = np.zeros((b, tb), np.float32) if "durations" in items[0] else None
        for i, it in enumerate(items):
            lx, ly = len(it["x"]), it["y"].shape[0]
            x[i, :lx] = it["x"]
            x_lengths[i] = lx
            y[i, :ly] = it["y"][: min(ly, mb)]
            y_lengths[i] = min(ly, mb)
            spks[i] = it["spk"]
            if durs is not None:
                durs[i, :lx] = it["durations"]
        batch = {"x": x, "x_lengths": x_lengths, "y": y, "y_lengths": y_lengths, "spks": spks}
        if durs is not None:
            batch["durations"] = durs
        return batch


class Prefetcher:
    """Single background thread keeping `depth` batches ready (replaces the
    reference's DataLoader worker processes)."""

    def __init__(self, iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = depth

    def __iter__(self):
        q: Queue = Queue(maxsize=self.depth)
        _END = object()
        stop = threading.Event()  # set when the consumer abandons the epoch

        def _put(item) -> bool:
            # bounded puts so an abandoned consumer (train loop `break` on
            # max_steps/limit_train_batches) can't strand this thread on a
            # full queue forever, pinning buffered batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except Full:
                    continue
            return False

        def worker():
            try:
                for item in self.iterable:
                    if not _put(item):
                        return
            finally:
                _put(_END)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                yield item
        finally:
            stop.set()  # GeneratorExit on early break lands here
