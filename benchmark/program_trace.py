"""The program's own spans and counters (`spumoni_tpu_torch.trace`), read in
`--trace 1` runs.

A `run` call that starts while torch.profiler records keeps its spans and
counters in memory; after the window `trace.snapshot()` returns them, with
times on `time.perf_counter_ns`, the clock of the device intervals
(`DeviceTrace`, moved there by the benchmark's marker). A program without
the tracer, or a run with no call recorded in the window, reads None, and
its metrics are left out of the result line.

The main thread's spans say what it waited on while the card was idle:
`feed.wait_input` (the prefetch thread: parse, digestion, staging),
`feed.wait_writer` and `run.drain` (the writer thread), `run.load` (index,
null database, files), `device.*` (launches, fetches, the per-read cut);
outside every `run` span the harness is between calls; what is left inside
a call is unexplained.
"""

from __future__ import annotations

import numpy as np

from .trace import merged

MAIN = {"input": ("feed.wait_input",),
        "writer": ("feed.wait_writer", "run.drain"),
        "load": ("run.load",),
        "device": ("device.launch", "device.fetch", "device.split")}
#: the staging decode (K11, K12): no scan launches
DECODE = ("unpack2", "unpack4")


def window(ctx) -> tuple:
    if getattr(ctx, "device", None) is not None:
        return ctx.device.window
    return ctx.calls[0]["start"], ctx.calls[-1]["end"]


def program(ctx):
    """{'spans', 'counts'} of the `run` calls inside the window (a call is
    in it where its `run` span's midpoint is), times in seconds; None where
    the program has no tracer or recorded no call there."""
    snap = getattr(ctx, "program", None)
    if snap is None:
        try:
            import spumoni_tpu_torch.trace as trace
        except ImportError:
            return None
        snap = trace.snapshot()
    a, b = window(ctx)
    spans = [dict(s, start=s["start"] * 1e-9, end=s["end"] * 1e-9)
             for s in snap["spans"]]
    calls = {s["call"] for s in spans if s["name"] == "run"
             and a <= (s["start"] + s["end"]) / 2 <= b}
    if not calls:
        return None
    return {"spans": [s for s in spans if s["call"] in calls],
            "counts": [c for c in snap["counts"] if c["call"] in calls]}


def intervals(spans, names, win) -> np.ndarray:
    """The union of the named spans, clipped to the window."""
    iv = np.array([[s["start"], s["end"]] for s in spans
                   if s["name"] in names], float).reshape(-1, 2)
    return merged(np.clip(iv, *win))


def length(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0


def overlap(x: np.ndarray, y: np.ndarray) -> float:
    """Length of the intersection of two unions of disjoint sorted
    intervals."""
    i = j = 0
    tot = 0.0
    while i < len(x) and j < len(y):
        lo, hi = max(x[i, 0], y[j, 0]), min(x[i, 1], y[j, 1])
        if hi > lo:
            tot += hi - lo
        if x[i, 1] < y[j, 1]:
            i += 1
        else:
            j += 1
    return tot


def idle_split(ctx):
    """Shares of the window (%) in which the card ran no kernel or copy,
    by what the main thread was in: input, writer, load, device; between
    calls (outside every `run` span); unexplained (in a call, in none of
    those); and `idle`, their sum. None without both traces."""
    snap = program(ctx)
    dev = getattr(ctx, "device", None)
    if snap is None or dev is None:
        return None
    win = window(ctx)
    recs = dev.kernels + dev.copies
    busy = merged(np.clip(np.array([[s, e] for _, s, e in recs],
                                   float).reshape(-1, 2), *win))
    if not len(busy):
        return None
    full = np.array([win], float)
    idle = length(full) - length(busy)
    split = {}
    for key, names in MAIN.items():
        iv = intervals(snap["spans"], names, win)
        split[key] = length(iv) - overlap(iv, busy)
    calls = intervals(snap["spans"], ("run",), win)
    split["between"] = (length(full) - length(calls)) - (
        length(busy) - overlap(calls, busy))
    split["unexplained"] = idle - sum(split.values())
    split["idle"] = idle
    return {k: 100.0 * v / ctx.window_s for k, v in split.items()}


def idle_input_share(ctx):
    split = idle_split(ctx)
    return None if split is None else split["input"]


def idle_writer_share(ctx):
    split = idle_split(ctx)
    return None if split is None else split["writer"]


def writer_busy_ms_per_mbp(ctx):
    """The writer thread's `writer.batch` spans (formatting, binmax, flush
    and cursor) over the window's input Mbp."""
    snap = program(ctx)
    if snap is None:
        return None
    busy = length(intervals(snap["spans"], ("writer.batch",), window(ctx)))
    return 1e3 * busy / (ctx.bases_per_call * len(ctx.calls) / 1e6)


def _total(snap, keep) -> int:
    return sum(c["n"] for c in snap["counts"] if keep(c["name"]))


def pad_share(ctx):
    """1 - scanned symbols / lane slots (lanes x padded length), in %."""
    snap = program(ctx)
    if snap is None:
        return None
    slots = _total(snap, lambda n: n == "slots")
    if not slots:
        return None
    return 100.0 * (1.0 - _total(snap, lambda n: n == "symbols") / slots)


def lanes_per_launch(ctx):
    """Staged lanes over the scan launches (every kernel but the staging
    decode) of the window's calls."""
    snap = program(ctx)
    if snap is None:
        return None
    scans = _total(snap, lambda n: n.startswith("launches.")
                   and n.split(".", 1)[1] not in DECODE)
    if not scans:
        return None
    return _total(snap, lambda n: n == "lanes") / scans
