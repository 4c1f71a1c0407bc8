"""Graceful-preemption handling for long training runs: a copy of
:mod:`sparsify_clip_tpu.utils.preemption`.

Managed schedulers deliver SIGTERM with a grace window before killing
the process.  The reference loses everything
not covered by its coarse epoch checkpoints (sparsify_clip.py:982-984);
here the train loop finishes the in-flight step, writes a FULL train
state (params, optimizer moments, step, temperature — the
``resume_checkpoint: "auto"`` format), and exits cleanly, so a
restarted run continues exactly where the signal landed.

The handler only sets a flag — everything slow (device sync, the
checkpoint) happens on the normal control path, outside async-signal
context.  Installed around the CLI's training section when
``handle_preemption: true`` (the default).
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable


class GracefulShutdown:
    """Context manager: flags (instead of raising on) SIGTERM/SIGINT.

    Inside the ``with`` block the listed signals set ``requested``
    instead of killing the process; previous handlers are restored on
    exit.  A repeated SIGTERM still only re-sets the flag — the
    grace-window save must not be interrupted by a retry from the
    scheduler.  A second SIGINT (a human pressing Ctrl-C twice) raises
    ``KeyboardInterrupt``: the first asks for a graceful checkpoint,
    the second means "actually stop now".

    Signal handlers can only be installed from the main thread; when
    entered elsewhere (e.g. a worker thread running an experiment),
    this degrades to an inert flag that never fires, and says so.
    """

    def __init__(
        self, signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT)
    ):
        self.signals = tuple(signals)
        self._requested = False
        self._previous = {}
        self.active = False

    @property
    def requested(self) -> bool:
        return self._requested

    def requested_fn(self) -> bool:
        """Poll callable for loops (``stop_fn=shutdown.requested_fn``)."""
        return self._requested

    def _handler(self, signum, frame):
        if self._requested and signum == signal.SIGINT:
            raise KeyboardInterrupt  # second Ctrl-C: stop now
        self._requested = True
        print(
            f"[preemption] caught signal {signum}: finishing the current "
            "step, then checkpointing full train state", flush=True
        )

    def __enter__(self) -> "GracefulShutdown":
        if threading.current_thread() is not threading.main_thread():
            print(
                "[preemption] not on the main thread — signal handlers "
                "not installed; preemption flag will never fire", flush=True
            )
            return self
        for sig in self.signals:
            self._previous[sig] = signal.signal(sig, self._handler)
        self.active = True
        return self

    def __exit__(self, *exc):
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
        self.active = False
        return False
