"""The readers of the program's own spans and counters
(benchmark/program_trace.py): the card's idle time split by what the main
thread waited on, spans cut at the window's edge, the counters' shares, and
None where a run holds no snapshot."""

import sys

import pytest

from benchmark import program_trace as pt
from benchmark.run import Readings, reader, run_cell
from benchmark.trace import DeviceTrace
from conftest import tiny

MS = 1_000_000   # ns


def _span(name, t0, t1, call=0, batch=None, thread="MainThread"):
    return {"id": 0, "parent": None, "name": name, "start": t0 * MS,
            "end": t1 * MS, "thread": thread, "call": call, "batch": batch}


def _count(name, n, call=0, batch=0):
    return {"name": name, "n": n, "t": 0, "call": call, "batch": batch}


def _ctx(spans, counts=(), device=True, window=(0.0, 1.0)):
    """A run with one call from 10 to 990 ms of a one-second window: the
    card busy 100-200 ms and 600-650 ms."""
    dev = DeviceTrace([("k", 0.1, 0.2)], [("Memcpy HtoD", 0.6, 0.65)],
                      window) if device else None
    snap = {"spans": [_span("run", 10, 990)] + list(spans),
            "counts": list(counts)}
    return Readings(window_s=window[1] - window[0], bases_per_call=2_000_000,
                    calls=[{"start": window[0], "end": window[1]}],
                    device=dev, program=snap)


def test_idle_split_adds_up():
    ctx = _ctx([_span("run.load", 10, 50),
                _span("feed.wait_input", 50, 150),      # 50 ms idle
                _span("device.launch", 150, 160),       # busy
                _span("device.fetch", 160, 250),        # 50 ms idle
                _span("feed.wait_writer", 300, 700),    # 350 ms idle
                _span("run.drain", 900, 990)])
    split = pt.idle_split(ctx)
    assert split["load"] == pytest.approx(4.0)
    assert split["input"] == pytest.approx(5.0)
    assert split["device"] == pytest.approx(5.0)
    assert split["writer"] == pytest.approx(35.0 + 9.0)
    assert split["between"] == pytest.approx(2.0)
    # 250-300 and 700-900 ms: in the call, in no named span
    assert split["unexplained"] == pytest.approx(25.0)
    assert split["idle"] == pytest.approx(85.0)
    assert sum(v for k, v in split.items() if k != "idle") == \
        pytest.approx(split["idle"])
    assert reader("idle_input_share.report")(ctx) == pytest.approx(5.0)
    assert reader("idle_writer_share.values")(ctx) == pytest.approx(44.0)


def test_spans_straddling_the_window_are_cut():
    # the window is 0.5-1.5 s; a writer batch 400-600 ms counts 100 ms,
    # a wait on input 1,400-1,600 ms counts its 100 ms inside
    spans = [_span("writer.batch", 400, 600, thread="writer"),
             _span("writer.batch", 700, 800, thread="writer"),
             _span("feed.wait_input", 1400, 1600)]
    ctx = _ctx(spans, window=(0.5, 1.5))
    ctx.program["spans"][0] = _span("run", 450, 1450)
    assert reader("writer_busy_ms_per_mbp.report")(ctx) == \
        pytest.approx(200.0 / 2.0)
    assert pt.idle_split(ctx)["input"] == pytest.approx(10.0)


def test_calls_outside_the_window_are_left_out():
    ctx = _ctx([_span("writer.batch", 100, 300, call=0, thread="writer"),
                _span("run", 1200, 1400, call=1),
                _span("writer.batch", 1250, 1350, call=1, thread="writer")],
               [_count("slots", 100), _count("slots", 900, call=1)])
    snap = pt.program(ctx)
    assert {s["call"] for s in snap["spans"]} == {0}
    assert [c["n"] for c in snap["counts"]] == [100]
    assert pt.writer_busy_ms_per_mbp(ctx) == pytest.approx(100.0)


def test_counter_shares():
    counts = [_count("symbols", 700), _count("slots", 1024),
              _count("symbols", 200, batch=1), _count("slots", 256, batch=1),
              _count("lanes", 40), _count("lanes", 24, batch=1),
              _count("launches.pml_scan", 3), _count("launches.unpack2", 3),
              _count("launches.pml_scan", 1, batch=1)]
    ctx = _ctx([], counts, device=False)
    assert reader("pad_share.values")(ctx) == pytest.approx(
        100 * (1 - 900 / 1280))
    assert reader("lanes_per_launch.values")(ctx) == pytest.approx(64 / 4)
    assert pt.idle_split(ctx) is None      # no device trace
    assert pt.lanes_per_launch(_ctx([], counts[:6])) is None


def test_no_snapshot_reads_none(monkeypatch):
    ctx = _ctx([])
    ctx.program = None
    # a program without the tracer (the parent of this reader)
    monkeypatch.setitem(sys.modules, "spumoni_tpu_torch.trace", None)
    for name in ("idle_input_share.report", "idle_writer_share.report",
                 "writer_busy_ms_per_mbp.values", "pad_share.report",
                 "lanes_per_launch.values"):
        assert reader(name)(ctx) is None
    # a run whose calls lie outside the window
    ctx = _ctx([], [_count("slots", 10)], window=(2.0, 3.0))
    assert pt.program(ctx) is None and pt.pad_share(ctx) is None


def test_run_with_the_tracer_held_on(tmp_path):
    """A whole traced CPU run with the program's tracer on (the card's
    profiler turns it on there): its span and counter metrics read, the
    device's not."""
    from spumoni_tpu_torch import trace

    workload, cfg, cell = tiny("pml_values_long")
    trace.enable()
    try:
        res = run_cell(workload, 2**33 + 17, 1.0, True, device="cpu",
                       config=cfg, cell=cell, work=str(tmp_path / "w"))
    finally:
        trace.disable()
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert m["writer_busy_ms_per_mbp.values"]["value"] > 0
    assert 0 < m["pad_share.values"]["value"] < 100
    for name in ("idle_input_share.values", "idle_writer_share.values",
                 "lanes_per_launch.values"):   # no card, no launches
        assert name not in m
