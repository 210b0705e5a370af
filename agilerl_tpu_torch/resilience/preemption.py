"""Preemption-aware signal handling: the port of
``agilerl_tpu/resilience/preemption.py`` (whole; pure Python). The guard
flushes the port's telemetry sink (``observability/facade.py``).

Spot and preemptible GPU machines (and TPU pods) deliver SIGTERM with a grace
window before the hard kill. :class:`PreemptionGuard` converts that signal
into a cooperative request: the handler ONLY flips a flag — it may have
interrupted a frame holding the telemetry sink's (non-reentrant) lock, so
even the counter bump and JSONL flush are deferred to the next main-thread
``requested`` read at a step boundary. Signal handlers must never pickle
trees, touch the device, or take locks.

A second SIGINT still raises ``KeyboardInterrupt`` so an interactive ^C ^C
retains its "no really, stop NOW" meaning.

Guards do NOT assume they own the process-wide handlers: when a supervised
child (the pod launcher's role harness) installs an outer guard and a
training loop later installs its own, the inner guard's handler **chains**
to the previously-installed callable handler after flag-flipping. Both
guards observe the signal, so a launcher-forwarded SIGTERM plus the
process-group delivery of the same signal (double delivery) latches both
flags and stays on the graceful path — signal latching is idempotent,
mirroring the "one ^C after SIGTERM stays graceful" rule.
"""

from __future__ import annotations

import signal
import threading
from typing import Iterable, Optional


class PreemptionGuard:
    """Install SIGTERM/SIGINT handlers that request a final snapshot.

    Usage::

        guard = PreemptionGuard()
        guard.install()            # or: with PreemptionGuard() as guard:
        ...
        if guard.requested:        # checked at step boundaries
            snapshot_and_exit()

    ``request()`` triggers the same path programmatically (tests, external
    preemption notices polled from a metadata server).
    """

    def __init__(
        self,
        signals: Iterable[int] = (signal.SIGTERM, signal.SIGINT),
        registry=None,
        telemetry=None,
    ):
        self.signals = tuple(signals)
        self._registry = registry
        self.telemetry = telemetry
        self._requested = False
        self._installed = False
        self._prev_handlers: dict = {}
        self._pending_record: Optional[int] = None
        self._recorded = False
        self._sigint_seen = False

    # -- state ------------------------------------------------------------ #
    @property
    def requested(self) -> bool:
        """True once a preemption was requested. Reading this OUTSIDE signal
        context (the loops' step-boundary checks) performs the deferred
        counter/emit/sink-flush — the handler itself must never touch the
        sink's non-reentrant lock, which the interrupted frame may hold."""
        if self._pending_record is not None or (
            self._requested and not self._recorded
        ):
            signum, self._pending_record = self._pending_record, None
            self._record(signum)
        return self._requested

    def request(self, signum: Optional[int] = None) -> None:
        """Flag a preemption (the manual/test entry point — records the
        telemetry immediately; the signal handler defers it instead). Safe
        to call from any thread."""
        first = not self._requested
        self._requested = True
        if first:
            self._record(signum)

    def reset(self) -> None:
        """Clear a latched request (a reused Resilience object attaching to
        a fresh run must not replay the previous run's preemption)."""
        self._requested = False
        self._recorded = False
        self._pending_record = None
        self._sigint_seen = False

    def _record(self, signum: Optional[int]) -> None:
        if self._recorded:
            return
        self._recorded = True
        reg = self._registry
        if reg is None:
            from agilerl_tpu_torch.observability import get_registry

            reg = get_registry()
        reg.counter("resilience/preemptions_total").inc()
        reg.emit("preemption", signum=signum)
        self._flush_telemetry()

    def _flush_telemetry(self) -> None:
        """Flush the run's JSONL sink so the event stream is durable even if
        the grace window expires before the final snapshot commits. The
        sink's ``_resume_seq`` append-resume means the resumed run continues
        one seq-monotone stream."""
        telem = self.telemetry
        sink = None
        if telem is not None:
            sink = getattr(getattr(telem, "registry", None), "sink", None)
        if sink is None and self._registry is not None:
            sink = getattr(self._registry, "sink", None)
        flush = getattr(sink, "flush", None)
        if callable(flush):
            try:
                flush()
            except Exception:
                pass

    # -- signal plumbing --------------------------------------------------- #
    def _handler(self, signum, frame) -> None:
        # ONLY flag-flips here: the handler may have interrupted a frame
        # holding the JSONL sink's lock, so emit/flush must wait for the
        # next main-thread `requested` read (async-signal-safe discipline)
        # escalation needs a PRIOR ^C specifically: a SIGTERM (pod
        # preemption notice) followed by one ^C must still take the
        # graceful final-snapshot path, not die mid-step
        escalate = self._sigint_seen and signum == signal.SIGINT
        if signum == signal.SIGINT:
            self._sigint_seen = True
        self._requested = True
        if self._pending_record is None and not self._recorded:
            self._pending_record = signum if signum is not None else -1
        if escalate:
            # second ^C: the user means it — don't trap them in a slow
            # final-snapshot path
            raise KeyboardInterrupt
        # chain to whoever held this signal before us: a supervised child's
        # harness guard must still see the signal when an inner loop guard
        # installed over it. Only real callables chain — SIG_DFL/SIG_IGN are
        # sentinels, and the interpreter's default_int_handler would raise
        # KeyboardInterrupt mid-step, exactly what the graceful path avoids.
        prev = self._prev_handlers.get(signum)
        if callable(prev) and prev not in (
            signal.default_int_handler, self._handler
        ):
            prev(signum, frame)

    def install(self) -> "PreemptionGuard":
        """Install handlers (main thread only — a no-op elsewhere, where
        ``request()`` remains the entry point)."""
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            return self
        for sig in self.signals:
            try:
                self._prev_handlers[sig] = signal.signal(sig, self._handler)
            except (ValueError, OSError):  # pragma: no cover - exotic hosts
                pass
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):  # pragma: no cover
                pass
        self._prev_handlers = {}
        self._installed = False

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()
