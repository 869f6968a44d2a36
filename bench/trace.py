"""Host spans, the profiled window and what the benchmark reads from it.

``Spans`` records the harness's own spans around its calls into the
program (the host clock), and inside a profiled window also names them to
the profiler (``record_function``), so the device trace can be read by
them. ``Window`` is one ``torch.profiler`` window over CPU and CUDA
activity and its reduction: every device operation's interval, the device
busy time as the union of those intervals, device time by kernel name, and
the longest idle gaps by what the host was doing.

The interval union is a frozen copy from ``chip_smoke.py``
(``copy_overlap_us`` and the busy share of ``profile_window``).
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch


def union(intervals) -> list[list[float]]:
    """Sorted, merged [start, end] intervals (from ``copy_overlap_us``)."""
    merged: list[list[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Spans:
    """The harness's host spans: (name, start s, end s) on ``time.perf_counter``."""

    def __init__(self) -> None:
        self.items: list[tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()
        t0 = time.perf_counter()
        with ctx:
            yield
        self.items.append((name, t0, time.perf_counter()))

    def mean_ms(self, name: str, since: float = 0.0) -> Optional[float]:
        d = [b - a for n, a, b in self.items if n == name and a >= since]
        return 1e3 * sum(d) / len(d) if d else None


class Window:
    """One profiled window. After ``with window:`` ``kernels`` holds every
    device operation (name, start us, end us), ``busy_s`` their union and
    ``window_s`` the host clock's length of the window (it ends with a
    synchronize). ``span_names`` are the harness's spans, which the
    profiler also lists on the device: they are not operations."""

    def __init__(self, device, span_names) -> None:
        self.device = torch.device(device)
        self.span_names = set(span_names)
        self.kernels: list[tuple[str, float, float]] = []
        self.busy_s = 0.0
        self.window_s = 0.0
        self._spans: list[tuple[str, float, float]] = []
        self._host: list[tuple[str, float, float]] = []

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        from torch.autograd import DeviceType

        for e in self._prof.events():
            row = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if e.name not in self.span_names:
                    self.kernels.append(row)
            elif e.name in self.span_names:
                self._spans.append(row)
            else:
                self._host.append(row)
        self._merged = union((a, b) for _n, a, b in self.kernels)
        self.busy_s = sum(b - a for a, b in self._merged) / 1e6

    def device_s(self, *subs: str) -> tuple[float, int]:
        """(device seconds, operations) of the operations whose name holds
        any of ``subs``."""
        rows = [(a, b) for n, a, b in self.kernels if any(s in n for s in subs)]
        return sum(b - a for a, b in rows) / 1e6, len(rows)

    def top_ops(self, n: int = 10) -> list:
        by: dict[str, float] = {}
        for name, a, b in self.kernels:
            by[name] = by.get(name, 0.0) + (b - a) / 1e6
        return [[k[:120], v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest stretches with no device operation inside the
        harness's spans, each named by the innermost span and the innermost
        host operation at its middle."""
        if not self._spans:
            return []
        lo, hi = min(a for _n, a, _b in self._spans), max(b for _n, _a, b in self._spans)
        edges = [lo] + [x for iv in self._merged for x in iv] + [hi]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i]) for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i] and lo <= edges[i] < hi), reverse=True)[:n]
        out = []
        for length, start in gaps:
            mid = start + length / 2
            names = []
            for rows in (self._spans, self._host):
                inner = [(a, nm) for nm, a, b in rows if a <= mid <= b]
                names.append(max(inner)[1] if inner else "(none)")
            out.append([f"{names[0]} / {names[1]}"[:120], length / 1e6])
        return out
