"""What a traced run reads from ``torch.profiler``: device intervals and the
host spans around them.

Read from the profiler's raw events (``kineto_results``), which takes a
second where building its event tree takes minutes at the size of a
window.  Times are in nanoseconds of the profiler's clock, which host spans
and device events share.
"""

from __future__ import annotations

import bisect
from collections import defaultdict

#: every __global__ function of the program's hand-written kernels
#: (ligero_tpu_torch/csrc/*.cu)
PORT_KERNELS = ("ntt_pass_kernel", "ntt_stage_kernel", "blake2s_kernel",
                "sha256_tree_kernel", "sha256_chain_probe_kernel",
                "mont_mul_kernel", "row_combine_kernel",
                "poseidon_cols_kernel")


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def group(name: str) -> str:
    """A device event's group: its hand-written kernel, a copy or a set,
    or the kernel's own name, cut at its argument list."""
    for kernel in PORT_KERNELS:
        if kernel in name:
            return kernel
    if name.startswith(("Memcpy", "Memset")):
        return " ".join(name.split()[:2])
    return name.split("(")[0][:80]


class Trace:
    """Device events (name, start, end) and host spans (name, start, end)
    of one profiled window."""

    def __init__(self, prof):
        from torch.autograd import DeviceType

        self.device, self.spans = [], []
        for ev in prof.profiler.kineto_results.events():
            start, end = ev.start_ns(), ev.end_ns()
            if ev.device_type() == DeviceType.CUDA:
                if not ev.is_user_annotation():
                    self.device.append((ev.name(), start, end))
            elif ev.is_user_annotation():
                self.spans.append((ev.name(), start, end))
        self.device.sort(key=lambda e: e[1])
        self._starts = [e[1] for e in self.device]

    def spans_named(self, prefix: str) -> list[tuple[int, int]]:
        return sorted((s, e) for name, s, e in self.spans
                      if name.startswith(prefix))

    def _within(self, spans):
        """Device events that start inside one of ``spans``."""
        for s, e in spans:
            lo = bisect.bisect_left(self._starts, s)
            hi = bisect.bisect_right(self._starts, e)
            yield from self.device[lo:hi]

    def device_ns(self, spans, keep) -> int:
        """Summed duration of the device events inside ``spans`` whose
        group ``keep`` accepts."""
        return sum(e - s for name, s, e in self._within(spans)
                   if keep(group(name)))

    def busy_ns(self, spans) -> int:
        """The part of ``spans`` that the union of the device intervals
        starting in them covers."""
        total = 0
        for s, e in spans:
            for bs, be in _union([(a, min(b, e))
                                  for _, a, b in self._within([(s, e)])]):
                total += be - bs
        return total

    def top_device_ops(self, spans, count: int = 10):
        """[group, seconds] of the groups that took most device time."""
        sums = defaultdict(int)
        for name, s, e in self._within(spans):
            sums[group(name)] += e - s
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:count]
        return [[name, ns / 1e9] for name, ns in top]

    def idle_gaps(self, window: tuple[int, int], count: int = 10):
        """[label, seconds] of the device's idle time in ``window``, by
        what the host was doing: each gap cut at the host spans' bounds,
        each piece summed under the innermost span open over it ("client"
        outside every span)."""
        busy = _union([(s, e) for _, s, e in self._within([window])])
        gaps, cursor = [], window[0]
        for s, e in busy:
            if s > cursor:
                gaps.append((cursor, s))
            cursor = max(cursor, e)
        if cursor < window[1]:
            gaps.append((cursor, window[1]))
        # (time, 1 start / 0 end, span): an end before a start at one time
        bounds = sorted([(s, 1, i) for i, (_, s, _) in enumerate(self.spans)]
                        + [(e, 0, i)
                           for i, (_, _, e) in enumerate(self.spans)])
        sums, open_, j = defaultdict(int), [], 0

        def label():
            if not open_:
                return "client"
            inner = max(open_, key=lambda i: (self.spans[i][1],
                                                -self.spans[i][2]))
            return self.spans[inner][0].split("/")[0]

        for gs, ge in gaps:
            while j < len(bounds) and bounds[j][0] <= gs:
                _, starts, i = bounds[j]
                open_.append(i) if starts else open_.remove(i)
                j += 1
            at = gs
            while j < len(bounds) and bounds[j][0] < ge:
                t, starts, i = bounds[j]
                sums[label()] += t - at
                open_.append(i) if starts else open_.remove(i)
                at = t
                j += 1
            sums[label()] += ge - at
        top = sorted(sums.items(), key=lambda kv: -kv[1])[:count]
        return [[name, ns / 1e9] for name, ns in top]
