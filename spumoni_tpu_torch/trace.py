"""Spans and counters of `pipeline.run`, on the host's perf_counter clock.

Off by default: `span()` then returns one shared no-op context manager
after a single flag check, and `count()`, `set_batch()` and `launches()`
return at once. A `run` call records when

- `enable()` holds the tracer on (the benchmark, the tests);
- SPUMONI_TRACE=<path> is set: the call then writes its spans and counters
  to <path> as Chrome-trace JSON, which Perfetto opens (under P > 1
  processes one file a host, `distributed.shard_path`);
- it starts while a torch.profiler is recording: the spans then sit beside
  the profiler's kernels, and `snapshot()` after the profile returns them.

Every recording call (and `enable()`) first runs a
`torch.profiler.record_function("spn.clock")` at a known `perf_counter_ns`
(`snapshot()["anchors"]`), so a profiler trace of the run can be moved onto
the spans' clock.

Spans and counters are per batch and per phase, never per read. A span
holds its name, start and end (`time.perf_counter_ns`), its thread's name,
its parent span on that thread, the call (one id per `run` call) and the
batch: the index of the batch in the run's stream, the same on the
prefetch, main and writer threads (`set_batch`). A counter adds `n` to its
name in the call's current batch of its thread. Records are appended to
lists; one append is atomic under the GIL, so the hot path takes no lock.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import threading
import time

ENV = "SPUMONI_TRACE"
ANCHOR = "spn.clock"
SPAN_KEYS = ("id", "parent", "name", "start", "end", "thread", "call",
             "batch")
COUNT_KEYS = ("name", "n", "t", "call", "batch")

_on = False        # spans and counters are recorded
_held = False      # enable() holds the tracer on
_call = -1         # the recording run call's id
_calls = itertools.count()
_ids = itertools.count()
_local = threading.local()   # .stack (open span ids), .batch
_spans: list = []
_counts: list = []
_anchors: list = []


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _Span:
    __slots__ = ("name", "batch", "sid", "parent", "t0")

    def __init__(self, name: str, batch):
        self.name = name
        self.batch = batch if batch is not None else getattr(_local, "batch",
                                                             None)

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else None
        self.sid = next(_ids)
        stack.append(self.sid)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _local.stack.pop()
        _spans.append((self.sid, self.parent, self.name, self.t0, t1,
                       threading.current_thread().name, _call, self.batch))
        return False


def span(name: str, batch: int | None = None):
    """A context manager timing one phase; `batch` defaults to the
    thread's current batch."""
    if not _on:
        return NO_SPAN
    return _Span(name, batch)


def count(name: str, n: int) -> None:
    """Adds n to the counter `name` of the thread's current batch."""
    if _on:
        _counts.append((name, int(n), time.perf_counter_ns(), _call,
                        getattr(_local, "batch", None)))


def set_batch(batch: int | None) -> None:
    """The batch that this thread's next spans and counters belong to."""
    if _on:
        _local.batch = batch


def launches() -> dict | None:
    """`kernels.launch_counts()` while recording, else None: the start of
    a block whose launches `count_launches` counts."""
    if not _on:
        return None
    from .engine import kernels
    return kernels.launch_counts()


def count_launches(before: dict | None) -> None:
    """Counts each kernel's launches since `before` (`launches()`) as the
    counter `launches.<kernel wrapper>`."""
    if before is None:
        return
    for name, n in launches().items():
        if n > before.get(name, 0):
            count("launches." + name, n - before.get(name, 0))


def _profiling() -> bool:
    from torch.autograd import profiler
    return bool(getattr(profiler, "_is_profiler_enabled", False))


def _anchor(call_id: int) -> None:
    import torch
    t = time.perf_counter_ns()
    with torch.profiler.record_function(ANCHOR):
        pass
    _anchors.append({"call": call_id, "t": t})


@contextlib.contextmanager
def call(export: str | None = None):
    """One `run` call, under its `run` span where it records: while held
    on, with `export` (SPUMONI_TRACE's path; the call's records are written
    there at its end) or while a torch.profiler records."""
    global _on, _call
    if not (_held or export or _profiling()):
        yield
        return
    _on = True
    _call = cid = next(_calls)
    _anchor(cid)
    _local.batch = None
    try:
        with _Span("run", None):
            yield
    finally:
        _on = _held
        if export:
            write_chrome_trace(export, cid)


def enable() -> None:
    """Records from now on, every call and outside calls too; clears what
    was recorded."""
    global _on, _held
    clear()
    _held = _on = True
    _anchor(-1)


def disable() -> None:
    global _on, _held
    _held = _on = False


def clear() -> None:
    del _spans[:], _counts[:], _anchors[:]


def snapshot() -> dict:
    """{'spans': [SPAN_KEYS dicts, times in ns], 'counts': [COUNT_KEYS
    dicts], 'counters': {name: total}, 'launches': kernels.launch_counts(),
    'anchors': [{'call', 't'}]: -1 for enable()'s}."""
    from .engine import kernels
    counts = [dict(zip(COUNT_KEYS, c)) for c in list(_counts)]
    totals: dict = {}
    for c in counts:
        totals[c["name"]] = totals.get(c["name"], 0) + c["n"]
    return {"spans": [dict(zip(SPAN_KEYS, s)) for s in list(_spans)],
            "counts": counts, "counters": totals,
            "launches": kernels.launch_counts(), "anchors": list(_anchors)}


def chrome_trace(snap: dict, call_id: int) -> dict:
    """One call's records of the snapshot as a Chrome-trace object: a
    complete event ('X', microseconds) per span with its call, batch, id
    and parent; each counter's running total ('C'); the totals, launch
    counts and anchor under 'otherData'."""
    pid = os.getpid()
    tids: dict = {}
    events = []
    for s in snap["spans"]:
        if s["call"] != call_id:
            continue
        tid = tids.setdefault(s["thread"], len(tids) + 1)
        events.append({"name": s["name"], "ph": "X", "pid": pid, "tid": tid,
                       "ts": s["start"] / 1e3,
                       "dur": (s["end"] - s["start"]) / 1e3,
                       "args": {k: s[k] for k in ("call", "batch", "id",
                                                  "parent")}})
    running: dict = {}
    for c in snap["counts"]:
        if c["call"] != call_id:
            continue
        running[c["name"]] = running.get(c["name"], 0) + c["n"]
        events.append({"name": c["name"], "ph": "C", "pid": pid,
                       "ts": c["t"] / 1e3,
                       "args": {"total": running[c["name"]]}})
    events += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
                "args": {"name": name}} for name, tid in tids.items()]
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "otherData": {"clock": "perf_counter", "counters": running,
                          "launches": snap["launches"],
                          "anchors": [a for a in snap["anchors"]
                                      if a["call"] == call_id]}}


def write_chrome_trace(path: str, call_id: int) -> None:
    text = json.dumps(chrome_trace(snapshot(), call_id))
    with open(path, "w") as f:
        f.write(text)
