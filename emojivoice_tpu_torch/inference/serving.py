"""Dynamic-batching serving engine (PyTorch port of
``emojivoice_tpu_torch.inference.serving``).

Concurrent requests are coalesced into one padded-batch call of the
pipeline, so the fixed cost of a call (host→device copies and, above all,
the thousands of kernel launches of the eager CFM decode) is paid once per
batch instead of once per request, and the card sees batched products
instead of B = 1.  What that buys on the H100 is in ``PERF.md``.

``BatchingEngine`` wraps a ``SynthesisPipeline``:

- ``submit()`` enqueues a request and returns a ``concurrent.futures.Future``.
- A worker thread collects requests for at most ``max_wait_ms`` after the
  first arrival (or until ``max_batch``), merges the ones that share a
  program key (ODE steps, temperature, length_scale, denoiser_strength,
  language, keep_mel; texts and speaker ids vary freely within a batch),
  and dispatches one padded-batch ``synthesise_async`` call.
- Batch sizes are rounded up to the next entry of ``batch_buckets`` by
  repeating the final row, so the number of distinct shapes stays bounded
  (the first call at a shape pays allocator growth and cuDNN/cuFFT plan
  selection: ``warmup()`` takes them out of the serving path; the pad rows
  are trimmed from the results and never surface).
- Noise is PER ROW: every request carries a seed (caller-provided via
  ``submit(seed=...)`` or engine-drawn), and the pipeline gives each row its
  own generator, so a request inside a merged batch draws the identical
  noise as a direct batch-1 ``pipe.synthesise(seed=...)`` call at the same
  mel bucket, and the outputs agree to summation-order level (the libraries
  pick other algorithms per batch shape).  Same-seed rows of one batch are
  bit-identical.
- The engine runs a **depth-1 pipeline** on two threads: the worker dispatches
  batch N+1 while a results thread waits for batch N's device→host copies
  (the pipeline enqueues them with N's kernels) and resolves N's futures.  The
  JAX engine does both on one thread, because there a dispatch returns at
  once; here a dispatch is thousands of kernel launches and holds its thread
  about as long as the batch takes to compute, so a single thread would
  resolve N's futures only when N+1 is all but finished.  At most two batches
  are dispatched and unresolved at any time.  ``SynthesisResult.rtf*`` fields
  on this path span the dispatch→fetch window; the engine's throughput metric
  is utt/s from ``stats()``, not 1/rtf.

No external deps, two background threads; ``stats()`` exposes counters for
observability (batch-size histogram, queue wait, dispatch latency).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Optional, Sequence

from emojivoice_tpu_torch.utils.buckets import pick_bucket


@dataclass
class _Request:
    text: str
    spk: int
    key: tuple
    future: Future
    seed: int = 0
    t_submit: float = field(default_factory=time.monotonic)


class BatchingEngine:
    """Coalesces concurrent synthesis requests into padded-batch dispatches."""

    def __init__(
        self,
        pipe,
        max_batch: int = 8,
        max_wait_ms: float = 10.0,
        batch_buckets: Optional[Sequence[int]] = None,
        seed: int = 0,
        pcm16: bool = True,
    ):
        """Payload defaults are serving-lean: audio only, int16 on the wire
        (results still expose float32 wav; the mel field is empty unless a
        request asks), less than half the bytes of mel + f32 waveform per
        device→host copy.  ``submit(keep_mel=True)`` opts a request into the
        spectrogram (part of the program key, so it merges only with like
        requests)."""
        if batch_buckets is None:
            # powers of two up to max_batch (any max_batch works out of the box)
            batch_buckets = [1]
            while batch_buckets[-1] < max_batch:
                batch_buckets.append(batch_buckets[-1] * 2)
        if max_batch > max(batch_buckets):
            raise ValueError(f"max_batch {max_batch} exceeds largest batch bucket {max(batch_buckets)}")
        self.pipe = pipe
        self.pcm16 = pcm16
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.batch_buckets = tuple(sorted(batch_buckets))
        self._queue: queue.Queue = queue.Queue()
        self._seed = seed
        self._lock = threading.Lock()
        self._stats = {
            "requests": 0,
            "batches": 0,
            "batched_rows": 0,
            "pad_rows": 0,
            "errors": 0,
            "failed_batches": 0,
            "batch_hist": collections.Counter(),
            "wait_s_sum": 0.0,
            "dispatch_s_sum": 0.0,
        }
        # recent per-request queue waits for percentile reporting (bounded:
        # stats() stays O(window), old traffic ages out)
        self._waits = collections.deque(maxlen=1024)
        self._closed = False
        # dispatched batches on their way to the results thread; the slots bound the
        # dispatched-and-unresolved batches (and their device memory) to two
        self._in_flight: queue.Queue = queue.Queue()
        self._slots = threading.Semaphore(2)
        self._worker = threading.Thread(target=self._run, name="batching-engine", daemon=True)
        self._finalizer = threading.Thread(target=self._drain, name="batching-engine-results", daemon=True)
        self._finalizer.start()
        self._worker.start()

    # -- client side ------------------------------------------------------

    def submit(
        self,
        text: str,
        spk: int = 0,
        n_timesteps: Optional[int] = None,
        temperature: float = 0.667,
        length_scale: float = 1.0,
        denoiser_strength: Optional[float] = None,
        language: Optional[str] = None,
        keep_mel: bool = False,
        seed: Optional[int] = None,
    ) -> Future:
        """Enqueue one utterance; resolves to a SynthesisResult.

        ``seed`` pins this request's noise stream: the same seed always draws
        the same noise regardless of co-batched requests, and replays through
        the same batch shape are bit-identical.  None draws a fresh one.

        ``denoiser_strength=None`` takes the backend's own operating point:
        its ``denoiser_strength`` attribute where it has one, else the
        reference default 0.00025 (``n_timesteps`` likewise, default 10)."""
        if n_timesteps is None:
            n_timesteps = int(getattr(self.pipe, "n_timesteps", 10))
        if denoiser_strength is None:
            denoiser_strength = float(getattr(self.pipe, "denoiser_strength", 0.00025))
        if self._closed:
            raise RuntimeError("engine is closed")
        if language is not None:
            # fail fast in the caller, not inside a merged batch
            from emojivoice_tpu_torch.text.cleaners import LANGUAGE_CLEANERS

            if language not in LANGUAGE_CLEANERS:
                raise KeyError(f"Unknown language {language!r}; available: {sorted(LANGUAGE_CLEANERS)}")
        key = (int(n_timesteps), float(temperature), float(length_scale),
               float(denoiser_strength), language, bool(keep_mel))
        fut: Future = Future()
        # closed-check + put under the lock: a submit racing close() must not
        # slip a request behind the drain sentinel (its future would never
        # resolve while close() returns)
        with self._lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if seed is None:
                self._seed = (self._seed + 1) % (2**31 - 1)
                seed = self._seed
            self._queue.put(_Request(text=text, spk=int(spk), key=key, future=fut, seed=int(seed)))
            self._stats["requests"] += 1
        return fut

    def synthesise(self, text: str, **kw):
        """Blocking convenience wrapper around submit()."""
        return self.submit(text, **kw).result()

    def warmup(self, n_timesteps: Optional[int] = None,
               batches: Optional[Sequence[int]] = None):
        """Run one request per batch bucket with the flags this engine
        dispatches (keep_mel off, its pcm16), so first-call costs (the kernel
        build, allocator growth, cuDNN/cuFFT plan selection per shape) are
        paid before serving.  ``n_timesteps=None`` warms the backend's own
        operating point, like submit()."""
        if n_timesteps is None:
            n_timesteps = int(getattr(self.pipe, "n_timesteps", 10))
        for b in batches if batches is not None else self.batch_buckets:
            self.pipe.warmup(n_timesteps=n_timesteps, batch=b,
                             keep_mel=False, vocode=True, pcm16=self.pcm16)

    def stats(self) -> dict:
        with self._lock:
            s = dict(self._stats)
            s["batch_hist"] = dict(self._stats["batch_hist"])
            waits = sorted(self._waits)
        n_b = max(s["batches"], 1)
        s["mean_batch"] = s["batched_rows"] / n_b
        s["mean_wait_ms"] = 1e3 * s["wait_s_sum"] / max(s["requests"], 1)
        s["mean_dispatch_ms"] = 1e3 * s["dispatch_s_sum"] / max(s["batches"] + s["failed_batches"], 1)
        if waits:  # queue-wait percentiles over the recent window (≤1024 reqs)
            s["wait_ms_p50"] = 1e3 * waits[len(waits) // 2]
            s["wait_ms_p95"] = 1e3 * waits[min(len(waits) - 1, int(len(waits) * 0.95))]
        return s

    def close(self, timeout: float = 30.0):
        """Drain the queue, resolve every dispatched batch, stop both threads.  Idempotent."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._queue.put(None)  # wake the worker (after any in-flight submit)
        self._worker.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- worker side ------------------------------------------------------

    def _collect(self, first: _Request) -> tuple[list[_Request], list[_Request]]:
        """Gather requests sharing first's program key until max_batch or the
        wait window closes; non-matching requests are handed back."""
        batch, holdback = [first], []
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if req is None:  # close() sentinel — preserve it for _run
                self._queue.put(None)
                break
            (batch if req.key == first.key else holdback).append(req)
        return batch, holdback

    def _dispatch(self, batch: list[_Request]):
        """Synchronous dispatch+finalize (the poison-row isolation path)."""
        rec = self._dispatch_async(batch)
        if rec is not None:
            self._finalize(rec)

    def _fail(self, batch: list[_Request], e: Exception, t0: float):
        """Shared failure path for dispatch- and fetch-time errors."""
        with self._lock:
            # the failed attempt was a real dispatch: record it so
            # monitoring can see batch-level failures happening at all
            self._stats["failed_batches"] += 1
            self._stats["dispatch_s_sum"] += time.monotonic() - t0
        if len(batch) > 1:
            # isolate the poison row: the co-batched requests are
            # innocent (e.g. one text overflows the largest bucket) —
            # re-dispatch each alone so only the bad one fails
            for r in batch:
                self._dispatch([r])
            return
        self._resolve(batch[0].future, exc=e)
        with self._lock:
            self._stats["errors"] += 1

    def _dispatch_async(self, batch: list[_Request]):
        """Enqueue one padded batch on the device WITHOUT fetching
        results; returns an in-flight record for _finalize, or None if the
        dispatch itself failed (already handled)."""
        n = len(batch)
        bucket = pick_bucket(n, self.batch_buckets)
        texts = [r.text for r in batch] + [batch[-1].text] * (bucket - n)
        spks = [r.spk for r in batch] + [batch[-1].spk] * (bucket - n)
        # per-row seeds: every row's noise is a function of its own request
        # seed, never of the co-batched rows (pad rows reuse the last seed
        # and are trimmed before results surface)
        seeds = [r.seed for r in batch] + [batch[-1].seed] * (bucket - n)
        steps, temp, ls, dn, language, keep_mel = batch[0].key
        t0 = time.monotonic()
        try:
            pending = self.pipe.synthesise_async(
                texts, spks=spks, n_timesteps=steps, temperature=temp, length_scale=ls,
                denoiser_strength=dn, language=language, seed=seeds,
                keep_mel=keep_mel, pcm16=self.pcm16,
            )
        except Exception as e:  # noqa: BLE001 — bad text/shape surfaces here
            self._fail(batch, e, t0)
            return None
        return (batch, n, bucket, pending, t0)

    def _finalize(self, rec):
        """Fetch a dispatched batch's outputs and resolve its futures."""
        batch, n, bucket, pending, t0 = rec
        try:
            results = self.pipe.finalize(pending)
        except Exception as e:  # noqa: BLE001 — runtime errors surface here
            self._fail(batch, e, t0)
            return
        dt_s = time.monotonic() - t0
        # update stats BEFORE resolving futures: callers read stats() as
        # soon as result() unblocks, and must see this batch counted
        with self._lock:
            self._stats["batches"] += 1
            self._stats["batched_rows"] += n
            self._stats["pad_rows"] += bucket - n
            self._stats["batch_hist"][bucket] += 1
            self._stats["dispatch_s_sum"] += dt_s
            self._stats["wait_s_sum"] += sum(t0 - r.t_submit for r in batch)
            self._waits.extend(t0 - r.t_submit for r in batch)
        for r, res in zip(batch, results):
            self._resolve(r.future, result=res)

    @staticmethod
    def _resolve(future: Future, result=None, exc=None):
        """Resolve a future, tolerating client-side Future.cancel(): a caller
        that timed out and cancelled leaves the future CANCELLED, and a bare
        set_result would raise InvalidStateError and kill the worker thread."""
        if not future.set_running_or_notify_cancel():
            return  # cancelled by the client — drop the result
        if exc is not None:
            future.set_exception(exc)
        else:
            future.set_result(result)

    def _run(self):
        # Dispatch side of the depth-1 pipeline: collect a batch, take a slot,
        # enqueue it on the device, hand it to the results thread.
        while True:
            req = self._queue.get()
            if req is None:
                if self._closed and self._queue.empty():
                    self._in_flight.put(None)  # after every dispatched batch: drain, then stop
                    self._finalizer.join()
                    return
                self._queue.put(None)  # keep the sentinel until the queue drains
                continue
            batch, holdback = self._collect(req)
            for h in holdback:  # different program key → next round
                self._queue.put(h)
            self._slots.acquire()
            rec = self._dispatch_async(batch)
            if rec is None:  # failed at dispatch, already handled
                self._slots.release()
            else:
                self._in_flight.put(rec)

    def _drain(self):
        # Results side: wait for each dispatched batch's copies, in order, and
        # resolve its futures while the worker dispatches the next batch.
        while True:
            rec = self._in_flight.get()
            if rec is None:
                return
            try:
                self._finalize(rec)
            finally:
                self._slots.release()
