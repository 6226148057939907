"""The device trace of a ``--trace 1`` run.

``torch.profiler`` with the CUDA activity alone (device activities and the
host's CUDA runtime calls; recording every host operator as well slowed a
host-bound batch by 70%) covers the traced part of the measured window:
the first ``min(seconds, TRACE_S)`` seconds of a batch loop, so that
reading the trace stays a few seconds. The profiler is
started once during set-up (:meth:`Tracer.warm`), so that its own start-up
falls outside the window. What it yields:

- ``kernels``: every device activity (kernels, copies, fills) as
  ``(name, start_ns, end_ns)``;
- ``busy_s``: the union of those intervals; ``window_s``: the traced
  window, from its first recorded event to its last;
- ``device_ops``: device seconds by name, the ten largest;
- ``idle_gaps``: idle device seconds by what the host was doing at each
  gap's midpoint (the innermost CUDA runtime call there, or "no event"
  where the host was in Python or in its own work), the ten largest.
"""

from __future__ import annotations

import bisect
import dataclasses
import time

TRACE_S = 3.0
_NAME_CHARS = 160
_LOOK_BACK = 256      # host events searched back from a gap's midpoint


@dataclasses.dataclass
class Trace:
    kernels: list          # (name, start_ns, end_ns), device activities
    host: list             # (name, start_ns, end_ns), host events
    t0_ns: int
    t1_ns: int

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e9

    def busy_intervals(self):
        spans = sorted((s, e) for _, s, e in self.kernels)
        merged = []
        for s, e in spans:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def idle_pct(self) -> float | None:
        """The window less the union of device activity, in percent."""
        if self.window_s <= 0 or not self.kernels:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_seconds(self, part: str) -> tuple[float, int]:
        """Device seconds and launches of activities whose name holds ``part``."""
        hits = [(e - s) for name, s, e in self.kernels if part in name]
        return sum(hits) / 1e9, len(hits)

    def device_ops(self, top: int = 10) -> list:
        by = {}
        for name, s, e in self.kernels:
            key = name[:_NAME_CHARS]
            by[key] = by.get(key, 0) + (e - s)
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        gaps, prev = [], self.t0_ns
        for s, e in self.busy_intervals() + [[self.t1_ns, self.t1_ns]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by = {}
        for g0, g1 in gaps:
            mid = (g0 + g1) // 2
            inner = None
            # the innermost event around ``mid`` started latest: look back
            # from the last event that started before it
            last = bisect.bisect_right(starts, mid) - 1
            for j in range(last, max(-1, last - _LOOK_BACK), -1):
                name, s, e = host[j]
                if e >= mid and (inner is None or e - s < inner[1]):
                    inner = (name, e - s)
            key = ("host: " + inner[0][:_NAME_CHARS]) if inner else "host: no event"
            by[key] = by.get(key, 0) + (g1 - g0)
        return [[n, v / 1e9] for n, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]


class Tracer:
    """Runs the profiler over the traced part of a window; inert when off."""

    def __init__(self, on: bool, seconds: float, cuda: bool = True):
        self.on = on
        self.cuda = cuda
        self.span_s = min(seconds, TRACE_S)
        self._prof = None
        self._t0 = None
        self.result: Trace | None = None

    @property
    def active(self) -> bool:
        return self._prof is not None

    def _profile(self):
        import torch

        act = torch.profiler.ProfilerActivity
        # a CPU run (the tests) has no CUDA activity to record
        return torch.profiler.profile(activities=[act.CUDA if self.cuda else act.CPU])

    def warm(self, sync) -> None:
        """Start and stop the profiler once over a device wait (set-up)."""
        if self.on:
            with self._profile():
                sync()

    def start(self) -> None:
        if not self.on:
            return
        self._prof = self._profile()
        self._prof.__enter__()
        self._t0 = time.monotonic_ns()

    def due(self) -> bool:
        """True once the traced part of the window has run its length."""
        return self.active and time.monotonic_ns() - self._t0 >= self.span_s * 1e9

    def stop(self, sync) -> None:
        """Close the traced window: wait for the device (``sync``), then
        stop the profiler and keep its events."""
        if not self.active:
            return
        sync()
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        kernels, host = [], []
        for ev in prof.profiler.kineto_results.events():
            s = ev.start_ns()
            e = s + ev.duration_ns()
            if ev.device_type().name == "CUDA":
                kernels.append((ev.name(), s, e))
            else:
                host.append((ev.name(), s, e))
        # the profiler's clock differs from one torch build to another, so
        # the window is the recorded events' own extent
        both = kernels + host
        t0 = min((s for _, s, _ in both), default=0)
        t1 = max((e for _, _, e in both), default=0)
        self.result = Trace(kernels, host, t0, t1)
