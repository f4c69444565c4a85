"""Phase timer and device traces for the port's prover and verifier.

CUDA work is asynchronous: a host clock read without a barrier measures
the enqueue, not the work.  :class:`PhaseTimer` therefore synchronises the
current CUDA stream at every phase boundary (entry and exit), so each
phase is billed the device time it issued on that stream.  That costs the
overlap between phases (the JAX package's ``sync`` mode, here always on);
the totals are what a synchronous caller waits for.  Work on another
stream (the opened columns' gathers and copies, ``TorchBackend.
gather_columns_start``) runs on across the boundaries and is billed where
the prover waits for it (``open.gather``).

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


class PhaseTimer:
    """Wall-clock accumulator per named phase (``totals`` in seconds,
    ``counts`` of entries), synchronised with the current CUDA stream at
    phase boundaries.  Disabled timers cost nothing."""

    def __init__(self, enabled: bool = False):
        self.enabled = enabled
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.current_stream().synchronize()

    @contextlib.contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()

    def report(self) -> str:
        """One line a phase, the longest first: its total and its count."""
        return "\n".join(
            f"{name:32s} {self.totals[name]*1e3:10.2f} ms  x{self.counts[name]}"
            for name in sorted(self.totals, key=self.totals.get,
                               reverse=True))


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
