"""The traced run's readings: host spans around the program's layers, the
profiler's device intervals, and their reduction.

`Spans` wraps module attributes that the program calls (installed only for
`--trace 1`): each call's host interval is added to its layer's total and
kept for the idle-gap breakdown (calls less than 50 us apart merge into one
interval, so a per-read writer keeps few). Intervals are on
`time.perf_counter`; `DeviceTrace.from_profiler` moves the profiler's
device intervals onto that clock by one marker event recorded at a known
host time.
"""

from __future__ import annotations

import functools
import threading
import time

import numpy as np

_MERGE_S = 50e-6


class Spans:
    def __init__(self):
        self.total: dict[str, float] = {}
        self.intervals: dict[str, list] = {}
        self._lock = threading.Lock()
        self._undo: list = []

    def add(self, layer: str, t0: float, t1: float) -> None:
        with self._lock:
            self.total[layer] = self.total.get(layer, 0.0) + (t1 - t0)
            iv = self.intervals.setdefault(layer, [])
            if iv and t0 - iv[-1][1] < _MERGE_S and t0 >= iv[-1][0]:
                iv[-1][1] = max(iv[-1][1], t1)
            else:
                iv.append([t0, t1])

    def wrap(self, owner, attr: str, layer: str) -> None:
        fn = getattr(owner, attr)
        spans = self

        @functools.wraps(fn)
        def timed(*a, **k):
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans.add(layer, t0, time.perf_counter())

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def wrap_generator(self, owner, attr: str, layer: str) -> None:
        """Times each step of the generator that owner.attr returns."""
        fn = getattr(owner, attr)
        spans = self

        @functools.wraps(fn)
        def timed(*a, **k):
            it = iter(fn(*a, **k))
            while True:
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    spans.add(layer, t0, time.perf_counter())
                    return
                spans.add(layer, t0, time.perf_counter())
                yield item

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


def merged(iv: np.ndarray) -> np.ndarray:
    """The union of intervals as disjoint sorted intervals."""
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for a, b in iv[1:]:
        if a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.array(out)


class DeviceTrace:
    """Device intervals of the profiled window (seconds on the host's
    perf_counter clock), from torch.profiler's CUDA events."""

    def __init__(self, kernels, copies, window):
        self.kernels = kernels      # [(name, start_s, end_s)]
        self.copies = copies        # [(name, start_s, end_s)]
        self.window = window        # (start_s, end_s)

    @classmethod
    def from_profiler(cls, prof, marker: str, marker_t: float, window):
        from torch.autograd import DeviceType

        events = prof.events()
        mark = [e for e in events if e.name == marker]
        if not mark:
            return None
        shift = marker_t - mark[0].time_range.start * 1e-6
        kernels, copies = [], []
        for e in events:
            if e.device_type != DeviceType.CUDA:
                continue
            rec = (e.name, e.time_range.start * 1e-6 + shift,
                   e.time_range.end * 1e-6 + shift)
            low = e.name.lower()
            (copies if low.startswith(("memcpy", "memset")) else
             kernels).append(rec)
        return cls(kernels, copies, window)

    def _clipped(self, recs) -> np.ndarray:
        a, b = self.window
        iv = np.array([[s, e] for _, s, e in recs], float).reshape(-1, 2)
        return np.clip(iv, a, b)

    def busy_s(self) -> float:
        m = merged(self._clipped(self.kernels + self.copies))
        return float((m[:, 1] - m[:, 0]).sum()) if len(m) else 0.0

    def kernel_s(self) -> float:
        iv = self._clipped(self.kernels)
        return float((iv[:, 1] - iv[:, 0]).sum())

    def top_ops(self, k: int = 10):
        tot: dict[str, float] = {}
        for name, s, e in self.kernels + self.copies:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return sorted(([n[:120], v] for n, v in tot.items()),
                      key=lambda x: -x[1])[:k]

    def idle_gaps(self, spans: Spans, k: int = 10):
        """The k longest gaps between device intervals inside the window,
        each named by the host layers whose spans cover its midpoint."""
        a, b = self.window
        m = merged(self._clipped(self.kernels + self.copies))
        edges = np.concatenate([[a], m.reshape(-1), [b]]).reshape(-1, 2)
        gaps = [(s, e) for s, e in edges if e > s]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:k]:
            mid = (s + e) / 2
            names = sorted(layer for layer, iv in spans.intervals.items()
                           if any(x <= mid <= y for x, y in iv))
            out.append(["+".join(names) or "none", e - s])
        return out
