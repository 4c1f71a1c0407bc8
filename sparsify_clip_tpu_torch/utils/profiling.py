"""Tracing and profiling helpers, ported from
:mod:`sparsify_clip_tpu.utils.profiling`.

* :class:`ThroughputMeter`: pairs/s (per device) and step ms on the host
  clock, windowed over the recent steps; the train loop's meter.
* :func:`trace`: a context manager around ``torch.profiler`` (CPU
  activity, plus CUDA where a card is present) that writes a Chrome
  trace into a directory, the JAX ``jax.profiler`` trace's place.
* :func:`log_compile_time`: the seconds of a first call, fenced on its
  output's devices.  On the card a first kernel call is where the
  library is built with ``nvcc`` and launched for the first time.

The JAX ``enable_nan_debugging`` (``jax_debug_nans``) has its counterpart
in the config's ``debug_nans`` (:func:`sparsify_clip_tpu_torch.train.check_finite`),
which raises on the first non-finite loss or gradient.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import deque
from typing import Deque, Iterator, Optional, Tuple

import torch


class ThroughputMeter:
    """Windowed pairs/s meter.

    Call :meth:`start` once, then :meth:`step` with the batch size after
    each train step, after a read that fences it.  The window holds the
    last ``window`` steps: once more have run, the start, and the first
    (warm-up) step with it, leave it.  ``n_chips`` defaults to the
    number of CUDA devices, or 1 without one."""

    def __init__(self, window: int = 50, n_chips: Optional[int] = None):
        self.window = window
        self.n_chips = n_chips or max(torch.cuda.device_count(), 1)
        self._times: Deque[Tuple[float, int]] = deque(maxlen=window + 1)

    def start(self) -> None:
        self._times.clear()
        self._times.append((time.perf_counter(), 0))

    def step(self, batch_size: int) -> None:
        self._times.append((time.perf_counter(), batch_size))

    @property
    def pairs_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        (t0, _), (t1, _) = self._times[0], self._times[-1]
        pairs = sum(b for _, b in list(self._times)[1:])
        return pairs / max(t1 - t0, 1e-9)

    @property
    def pairs_per_sec_per_chip(self) -> float:
        return self.pairs_per_sec / self.n_chips

    @property
    def step_time_ms(self) -> float:
        if len(self._times) < 2:
            return 0.0
        (t0, _), (t1, _) = self._times[0], self._times[-1]
        return (t1 - t0) / (len(self._times) - 1) * 1000


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """``with trace(d) as prof:`` profiles the block (CPU, and CUDA where a
    card is present) and writes ``<d>/trace_<pid>_<ns>.json``, a Chrome
    trace; ``prof.key_averages()`` sums it by name."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def _synchronize_outputs(out) -> None:
    """Wait for the CUDA devices of the tensors in ``out`` (nested lists,
    tuples and dicts)."""
    devices = set()
    stack = [out]
    while stack:
        item = stack.pop()
        if isinstance(item, torch.Tensor):
            if item.is_cuda:
                devices.add(item.device)
        elif isinstance(item, dict):
            stack.extend(item.values())
        elif isinstance(item, (list, tuple)):
            stack.extend(item)
    for device in devices:
        torch.cuda.synchronize(device)


def log_compile_time(fn, *args, label: str = "fn", fence=None):
    """Run ``fn(*args)`` once, fence with ``fence(out)`` (default: wait
    for the devices of the output's tensors), and return (out, seconds).
    ``label`` names the call, as on the JAX side."""
    del label
    t0 = time.perf_counter()
    out = fn(*args)
    (_synchronize_outputs if fence is None else fence)(out)
    return out, time.perf_counter() - t0
