"""The readers of the `ms_doc_values` cell's two metrics on hand-made
snapshots of the program's spans and counters, and a traced CPU run of the
cell's traffic file (cut to `tiny`'s gamma lengths) that reads both."""

import json
import os
import sys

import pytest

from benchmark.run import Readings, reader, run_cell
from conftest import ROOT

MS = 1_000_000   # ns


def _span(name, t0, t1, call=0):
    return {"id": 0, "parent": None, "name": name, "start": t0 * MS,
            "end": t1 * MS, "thread": "MainThread", "call": call,
            "batch": None}


def _ctx(spans, counts=()):
    """Two calls in a one-second window (0-500 and 500-1,000 ms)."""
    snap = {"spans": [_span("run", 0, 500), _span("run", 500, 1000, 1)]
            + list(spans),
            "counts": [{"name": n, "n": v, "t": 0, "call": c, "batch": 0}
                       for n, v, c in counts]}
    return Readings(window_s=1.0, bases_per_call=1_000_000,
                    calls=[{"start": 0.0, "end": 0.5},
                           {"start": 0.5, "end": 1.0}], program=snap)


LOADS = [_span("load.index", 0, 40), _span("load.msrows", 40, 70),
         _span("load.jumps", 70, 80), _span("load.upload", 80, 90),
         _span("load.index", 500, 530, 1), _span("load.msrows", 530, 550, 1),
         _span("load.jumps", 550, 560, 1)]
FORMATS = [_span("writer.format", 100, 300), _span("writer.format", 600, 700,
                                                   1)]


def test_ms_load_ms_per_call():
    ms_load = reader("ms_load_ms_per_call.values")
    # (40 + 30 + 10) + (30 + 20 + 10) ms over two calls
    assert ms_load(_ctx(LOADS)) == pytest.approx(70.0)
    # a fast-start call (rows cache only) or a program without the spans
    assert ms_load(_ctx([_span("load.rows", 0, 40),
                         _span("load.upload", 40, 50)])) is None
    assert ms_load(_ctx([s for s in LOADS
                         if s["name"] == "load.index"])) is None


def test_writer_ms_per_value_mb():
    per_mb = reader("writer_ms_per_value_mb.values")
    counts = [("value_bytes", 3_000_000, 0), ("value_bytes", 1_000_000, 1),
              ("symbols", 5, 0)]
    # 300 ms of formatting over 4 MB of value text
    assert per_mb(_ctx(FORMATS, counts)) == pytest.approx(75.0)
    assert per_mb(_ctx(FORMATS, counts[2:])) is None     # no value_bytes
    assert per_mb(_ctx(FORMATS, [("value_bytes", 0, 0)])) is None


def test_no_snapshot_reads_none(monkeypatch):
    ctx = _ctx(LOADS + FORMATS, [("value_bytes", 10, 0)])
    ctx.program = None
    monkeypatch.setitem(sys.modules, "spumoni_tpu_torch.trace", None)
    for name in ("ms_load_ms_per_call.values",
                 "writer_ms_per_value_mb.values"):
        assert reader(name)(ctx) is None


def test_cell_file():
    with open(os.path.join(ROOT, "benchmark", "cells",
                           "ms_doc_values.json")) as f:
        cell = json.load(f)
    with open(os.path.join(ROOT, "benchmark", "cells",
                           "pml_values_long.json")) as f:
        long = json.load(f)
    assert cell["flags"] == ["-M", "-c", "-d", "-n"]
    assert {k: v for k, v in cell.items() if k != "flags"} == \
        {k: v for k, v in long.items() if k != "flags"}


def test_traced_run_reads_both(tmp_path):
    """The cell's traffic on a tiny pangenome, gamma lengths cut as `tiny`
    cuts pml_values_long's, with the program's tracer held on."""
    from benchmark import run
    from spumoni_tpu_torch import trace

    _, _, cfg, cell = run.cell_spec("ms_doc_values")
    cfg = dict(cfg, strains=3, strain_len=30000)
    cell = dict(cell, reads=16, check_reads=8,
                length=dict(cell["length"], mean=2000, sd=1500, max=8000))
    trace.enable()
    try:
        res = run_cell("ms_doc_values", 2**33 + 29, 1.0, True, device="cpu",
                       config=cfg, cell=cell, work=str(tmp_path / "w"))
    finally:
        trace.disable()
    assert res["correct"], res["checks"]
    assert "value_records_wrong" in res["checks"]
    m = res["metrics"]
    assert m["ms_load_ms_per_call.values"]["value"] > 0
    assert m["writer_ms_per_value_mb.values"]["value"] > 0
    assert 0 < m["pad_share.values"]["value"] < 100
