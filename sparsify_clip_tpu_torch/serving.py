"""Online serving runtime: dynamic batching in front of the encoders.

Port of :mod:`sparsify_clip_tpu.serving`, with the same behaviour:

* **Dynamic batching**: single-item requests are coalesced into device
  batches of up to ``max_batch``, waiting at most ``max_wait_ms`` from
  the first queued item.
* **Bucket padding**: batches are zero-padded up to a ladder of
  power-of-two sizes, so the device sees a handful of shapes.  PyTorch
  compiles nothing per shape, but cuBLAS picks its algorithms and the
  caching allocator its blocks per shape; :meth:`warmup` primes them.
* **Replicas**: pass a list of encoders (one per device, see
  :func:`replicate_clip_encoder`) and one runner thread per replica
  pulls batches from a shared queue.
* **Observable**: latency percentiles and the padded batch histogram.

PyTorch's grad mode and current CUDA device are thread-local, so each
runner thread enters ``torch.inference_mode()`` and sets its replica's
device itself; otherwise every batch would build an autograd graph on
whatever device the thread happened to default to.

Usage::

    server = BatchingEncoderServer(CLIPEncoder(model))
    fut = server.submit_image(pixels)        # (H, W, 3) float32
    emb = fut.result()                       # (D,) unit fp32
    server.close()
"""

from __future__ import annotations

import contextlib
import copy
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

LATENCY_WINDOW = 16384  # requests kept for the latency percentiles

__all__ = [
    "BatchingEncoderServer",
    "ServerStats",
    "bucket_ladder",
    "replicate_clip_encoder",
]


def replicate_clip_encoder(model, devices=None):
    """One :class:`~sparsify_clip_tpu_torch.inference.CLIPEncoder` per
    device, each over its own copy of the model.  ``devices`` defaults
    to every CUDA device; with none, it raises."""
    from sparsify_clip_tpu_torch.inference import CLIPEncoder

    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not devices:
        raise RuntimeError("no CUDA device to replicate onto; pass devices=")
    return [CLIPEncoder(copy.deepcopy(model).to(dev)) for dev in devices]


def bucket_ladder(max_batch: int) -> List[int]:
    """Power-of-two pad targets up to ``max_batch`` (always included)."""
    ladder, b = [], 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return ladder


@dataclass
class _Request:
    kind: str  # "image" | "tokens"
    payload: np.ndarray  # (H, W, 3) or (context_length,)
    future: Future = field(default_factory=Future)
    t_submit: float = field(default_factory=time.monotonic)


@dataclass
class ServerStats:
    """Snapshot of the server's counters (see :meth:`stats`)."""

    requests: int
    batches: int
    mean_batch: float
    batch_histogram: Dict[int, int]  # padded bucket size -> count
    latency_p50_ms: float
    latency_p99_ms: float
    errors: int
    replica_batches: List[int] = field(default_factory=list)


class BatchingEncoderServer:
    """Coalesce single-item encode requests into padded device batches.

    ``encoder``: one encoder, or a list of replicas.  Each needs
    ``encode_images((B,H,W,3) np) -> (B,D) tensor`` and
    ``encode_tokens((B,T) int np) -> (B,D) tensor``; a ``device``
    attribute names the device its runner thread selects.  Raw strings
    wait for the tokenizer's port, and the raw-uint8 image path of the
    JAX server for the port of ``ops/image.py`` (ROADMAP).

    One dispatcher thread serves both modalities, always working the
    queue whose head request has waited longest.  Formed batches land
    on a shared queue drained by one runner thread per replica.
    """

    def __init__(
        self,
        encoder: Any,
        max_batch: int = 256,
        max_wait_ms: float = 5.0,
        buckets: Optional[Sequence[int]] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        encoders = list(encoder) if isinstance(encoder, (list, tuple)) else [encoder]
        if not encoders:
            raise ValueError("need at least one encoder replica")
        self._replicas = [
            {"image": enc.encode_images, "tokens": enc.encode_tokens} for enc in encoders
        ]
        self._devices = [getattr(enc, "device", None) for enc in encoders]
        # expected request shapes: one wrong-sized payload must fail ITS
        # request at submit time, not every co-batched request at np.stack
        cfg = getattr(getattr(encoders[0], "model", None), "cfg", None)
        self.image_size = getattr(cfg, "image_size", None)
        self.context_length = getattr(cfg, "context_length", None)
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.buckets = sorted(set(int(b) for b in buckets)) if buckets else (
            bucket_ladder(self.max_batch)
        )
        if self.buckets[-1] < self.max_batch:
            raise ValueError(
                f"largest bucket {self.buckets[-1]} < max_batch {self.max_batch}"
            )

        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {"image": deque(), "tokens": deque()}
        self._stopped = False
        self._n_requests = 0
        self._n_batches = 0
        self._n_items_batched = 0
        self._n_errors = 0
        self._batch_hist: Dict[int, int] = {}
        self._replica_batches = [0] * len(self._replicas)
        self._latencies = deque(maxlen=LATENCY_WINDOW)
        self._batch_q: "queue.Queue" = queue.Queue()
        self._thread = threading.Thread(
            target=self._dispatch_loop, name="encoder-batcher", daemon=True
        )
        self._runners = [
            threading.Thread(
                target=self._runner_loop, args=(i,),
                name=f"encoder-replica-{i}", daemon=True,
            )
            for i in range(len(self._replicas))
        ]
        self._thread.start()
        for r in self._runners:
            r.start()

    # ------------------------------------------------------------- API

    def submit_image(self, image: np.ndarray) -> Future:
        """Queue one (H, W, 3) float32 normalized-pixel image → Future[(D,)]."""
        image = np.asarray(image, np.float32)
        if image.ndim != 3:
            raise ValueError(f"expected one (H, W, 3) image, got {image.shape}")
        if self.image_size is not None:
            expected = (self.image_size, self.image_size, 3)
            if image.shape != expected:
                raise ValueError(
                    f"expected a {expected} image, got {image.shape}: resize "
                    "on the client (mixed shapes cannot share a batch)"
                )
        return self._submit("image", image)

    def submit_tokens(self, tokens: np.ndarray) -> Future:
        """Queue one (T,) int32 token row → Future[(D,)]."""
        tokens = np.asarray(tokens, np.int32)
        if tokens.ndim != 1:
            raise ValueError(f"expected one (T,) token row, got {tokens.shape}")
        if self.context_length is not None and tokens.shape[0] != self.context_length:
            raise ValueError(
                f"expected a ({self.context_length},) token row, got "
                f"{tokens.shape}: pad/truncate to the model's context length"
            )
        return self._submit("tokens", tokens)

    def warmup(self, image_shape: Sequence[int], context_length: int) -> None:
        """Run one dummy batch per (modality, bucket, replica), so the
        first requests do not pay cuBLAS and allocator set-up."""
        for fns, device in zip(self._replicas, self._devices):
            with _on_device(device):
                for b in self.buckets:
                    fns["image"](np.zeros((b, *image_shape), np.float32))
                    fns["tokens"](np.zeros((b, context_length), np.int32))

    def stats(self) -> ServerStats:
        with self._lock:
            lat = sorted(self._latencies)
            batches = self._n_batches

            def pct(p):
                if not lat:
                    return 0.0
                return 1e3 * lat[min(len(lat) - 1, int(p * len(lat)))]

            return ServerStats(
                requests=self._n_requests,
                batches=batches,
                mean_batch=(self._n_items_batched / batches) if batches else 0.0,
                batch_histogram=dict(sorted(self._batch_hist.items())),
                latency_p50_ms=pct(0.50),
                latency_p99_ms=pct(0.99),
                errors=self._n_errors,
                replica_batches=list(self._replica_batches),
            )

    def close(self, timeout: float = 30.0) -> None:
        """Stop accepting work, flush queued requests, join the threads.

        The dispatcher posts the runners' stop sentinels itself when it
        finishes flushing, so a batch never lands behind a sentinel."""
        with self._cond:
            self._stopped = True
            self._cond.notify_all()
        self._thread.join(timeout)
        for r in self._runners:
            r.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ------------------------------------------------------ dispatcher

    def _submit(self, kind: str, payload: np.ndarray) -> Future:
        req = _Request(kind, payload)
        with self._cond:
            if self._stopped:
                raise RuntimeError("server is closed")
            self._queues[kind].append(req)
            self._n_requests += 1
            self._cond.notify_all()
        return req.future

    def _pick_kind_locked(self) -> Optional[str]:
        heads = [
            (q[0].t_submit, i, key)
            for i, (key, q) in enumerate(self._queues.items())
            if q
        ]
        return min(heads)[2] if heads else None

    def _dispatch_loop(self) -> None:
        try:
            self._dispatch_until_stopped()
        finally:
            # sentinels only after every queued request was flushed
            for _ in self._runners:
                self._batch_q.put(None)

    def _dispatch_until_stopped(self) -> None:
        while True:
            with self._cond:
                kind = self._pick_kind_locked()
                while kind is None and not self._stopped:
                    self._cond.wait(0.05)
                    kind = self._pick_kind_locked()
                if kind is None and self._stopped:
                    return
                pending = self._queues[kind]
                # wait out the batching window (deadline set by the
                # oldest request) unless the batch is already full
                deadline = pending[0].t_submit + self.max_wait_s
                while (
                    len(pending) < self.max_batch
                    and not self._stopped
                    and (remaining := deadline - time.monotonic()) > 0
                ):
                    self._cond.wait(remaining)
                take = [pending.popleft() for _ in range(min(len(pending), self.max_batch))]
            self._batch_q.put((kind, take))

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if b >= n:
                return b
        return self.buckets[-1]

    def _runner_loop(self, replica: int) -> None:
        with _on_device(self._devices[replica]), torch.inference_mode():
            while True:
                item = self._batch_q.get()
                if item is None:
                    return
                self._run_batch(replica, *item)

    def _run_batch(self, replica: int, kind: str, reqs: List[_Request]) -> None:
        # claim every future first: a client-side cancel() before this
        # wins, and a claimed future can no longer be cancelled, so the
        # set_result / set_exception calls below cannot raise
        reqs = [r for r in reqs if r.future.set_running_or_notify_cancel()]
        if not reqs:
            return
        n = len(reqs)
        padded = self._bucket(n)
        stacked = np.stack([r.payload for r in reqs])
        if padded > n:
            pad = np.zeros((padded - n, *stacked.shape[1:]), stacked.dtype)
            stacked = np.concatenate([stacked, pad])
        try:
            out = self._replicas[replica][kind](stacked)[:n].float().cpu().numpy()
        except Exception as exc:  # propagate to every waiter in the batch
            with self._lock:
                self._n_errors += n
            for r in reqs:
                r.future.set_exception(exc)
            return
        done = time.monotonic()
        with self._lock:
            self._n_batches += 1
            self._n_items_batched += n
            self._batch_hist[padded] = self._batch_hist.get(padded, 0) + 1
            self._replica_batches[replica] += 1
            for r in reqs:
                self._latencies.append(done - r.t_submit)
        for r, row in zip(reqs, out):
            r.future.set_result(row)


def _on_device(device):
    """Context that makes ``device`` current on this thread when it is a
    CUDA device; a no-op otherwise."""
    if device is not None and torch.device(device).type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()
