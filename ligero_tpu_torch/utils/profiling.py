"""Phase timer, spans, counters and device traces for the port's prover and
verifier.

Spans.  Every phase of an enabled :class:`PhaseTimer`, and every block
under :func:`span`, is a ``torch.profiler.record_function`` span while a
profiler records (:func:`trace`, or any ``torch.profiler.profile``), and
nothing else: the check is one flag.  Host spans and the device's events
share the profiler's clock, so a trace shows what the host did while the
device idled, and each phase's device work.

Nothing here synchronises the device.  CUDA work is asynchronous, so a
phase's total is the host wall of the phase: the enqueue of its launches
and the host work between them, and whatever it waits for (a copy to the
host, a synchronisation of its own).  Work a phase launches may run on after
it ends, on the current stream or on the side stream of the openings
(``TorchBackend.gather_columns_start``), as it does with the timer off.

A phase that runs once a proof of a batch carries the proof's index in
its name after a slash (``open.to_ints/1``): the span has the full name,
``totals`` and ``counts`` the part before the slash.

    timer = PhaseTimer(enabled=True)
    lig = LigeroCircuit(circuit, outputs, device="cuda", timer=timer)
    with trace("ligero-trace"):          # a Chrome trace of the call
        proof = lig.prove(...)
    print(timer.report())
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A profiler span named ``name`` over a ``with`` block while a profiler
    records; otherwise a context that does nothing."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NO_SPAN


class PhaseTimer:
    """Host wall per named phase (``totals`` in seconds, ``counts`` of
    entries), each phase a profiler span while one records, and
    ``counters`` of what the program counts (:meth:`add`).  A disabled
    timer records nothing and costs one attribute check a phase."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        self._open: list[str] = []      # the open phases, innermost last

    @contextlib.contextmanager
    def phase(self, name: str):
        """Time the block as ``name``, keyed by the part before a slash."""
        if not self.enabled:
            yield
            return
        key = name.split("/", 1)[0]
        self._open.append(key)
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
        finally:
            self.totals[key] += time.perf_counter() - t0
            self.counts[key] += 1
            self._open.pop()

    def add(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name@<innermost open phase>`` (``name``
        outside every phase)."""
        if self.enabled:
            key = f"{name}@{self._open[-1]}" if self._open else name
            self.counters[key] += n

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.counters.clear()

    def report(self) -> str:
        """One line a phase, the longest first: its total and its count;
        then one line a counter."""
        lines = [f"{name:32s} {self.totals[name]*1e3:10.2f} ms  "
                 f"x{self.counts[name]}"
                 for name in sorted(self.totals, key=self.totals.get,
                                    reverse=True)]
        lines += [f"{name:32s} {self.counters[name]:14d}"
                  for name in sorted(self.counters)]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` over the block, host and (where there is one) CUDA
    activity; on exit a Chrome trace (``chrome://tracing``, Perfetto,
    TensorBoard's profile plugin) is written into ``log_dir`` as
    ``ligero.<pid>.<ns>.pt.trace.json``.  Yields the profiler, whose
    ``key_averages()`` the caller may read."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, f"ligero.{os.getpid()}.{time.time_ns()}.pt.trace.json"))
