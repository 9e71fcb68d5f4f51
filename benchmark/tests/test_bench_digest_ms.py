"""The `digest_ms_values` and `ms_report` cells: the readers of
`layered_load_ms_per_call.*` on hand-made snapshots of the program's spans,
traced CPU runs of `digest_ms_values` (cut to `tiny`'s gamma lengths) whose
every check reads 0 where the control's do not, and a traced CPU run of
`ms_report` that goes through K3, K4 and K5."""

import json
import os
import sys

import pytest

from benchmark import control
from benchmark.run import Readings, reader, run_cell
from conftest import ROOT

MS = 1_000_000   # ns


def _span(name, t0, t1, call=0):
    return {"id": 0, "parent": None, "name": name, "start": t0 * MS,
            "end": t1 * MS, "thread": "MainThread", "call": call,
            "batch": None}


def _ctx(spans):
    """Two calls in a one-second window (0-500 and 500-1,000 ms)."""
    snap = {"spans": [_span("run", 0, 500), _span("run", 500, 1000, 1)]
            + list(spans), "counts": []}
    return Readings(window_s=1.0, bases_per_call=1_000_000,
                    calls=[{"start": 0.0, "end": 0.5},
                           {"start": 0.5, "end": 1.0}], program=snap)


# load.layered holds load.fields and load.text; load.upload is no part
LOADS = [_span("load.index", 0, 40), _span("load.layered", 40, 70),
         _span("load.fields", 40, 60), _span("load.text", 60, 70),
         _span("load.upload", 70, 90),
         _span("load.index", 500, 530, 1), _span("load.layered", 530, 540, 1),
         _span("load.fields", 530, 538, 1)]


@pytest.mark.parametrize("name", ["layered_load_ms_per_call.values",
                                  "layered_load_ms_per_call.report"])
def test_layered_load_ms_per_call(name, monkeypatch):
    read = reader(name)
    # (40 + 30) + (30 + 10) ms over two calls
    assert read(_ctx(LOADS)) == pytest.approx(55.0)
    # a block-bits call (no layered tables) or a program without the span
    assert read(_ctx([_span("load.index", 0, 40),
                      _span("load.msrows", 40, 70)])) is None
    assert read(_ctx([s for s in LOADS
                      if s["name"] != "load.layered"])) is None
    ctx = _ctx(LOADS)
    ctx.program = None
    monkeypatch.setitem(sys.modules, "spumoni_tpu_torch.trace", None)
    assert read(ctx) is None


def _load(sub, name):
    with open(os.path.join(ROOT, "benchmark", sub, name + ".json")) as f:
        return json.load(f)


def test_cell_files():
    """digest_ms_values takes pml_values_long's reads, ms_report
    pml_report's; the configuration is ecoli10_digest's strains built -m
    -M."""
    for cell, like, flags in (
            ("digest_ms_values", "pml_values_long", ["-m", "-M", "-c"]),
            ("ms_report", "pml_report", ["-M", "-c", "-n", "--report-only"])):
        got, want = _load("cells", cell), _load("cells", like)
        assert got["flags"] == flags
        assert {k: v for k, v in got.items() if k != "flags"} == \
            {k: v for k, v in want.items() if k != "flags"}
    ms, pml = (_load("configs", c) for c in ("ecoli10_digest_ms",
                                             "ecoli10_digest"))
    assert ms["build_flags"] == ["-m", "-M"]
    assert {k: ms[k] for k in ("strains", "strain_len", "divergence",
                               "build")} == \
        {k: pml[k] for k in ("strains", "strain_len", "divergence", "build")}


def _tiny_digest_ms():
    from benchmark import run

    _, _, cfg, cell = run.cell_spec("digest_ms_values")
    cfg = dict(cfg, strains=3, strain_len=30000)
    cell = dict(cell, reads=16, check_reads=8,
                length=dict(cell["length"], mean=2000, sd=1500, max=8000))
    return cfg, cell


@pytest.mark.parametrize("seed", [7, 8])
def test_digest_ms_values_traced_run_and_control(seed, tmp_path):
    """The cell's traffic on a tiny pangenome with the program's tracer
    held on: every check reads 0 (the reads hold symbols past the index's
    last, where the layered walk follows SPUMONI's), the new metric reads
    the layered load, and the counters and spans are in the snapshot. The
    control (the tie reversed) fails the same reads."""
    from spumoni_tpu_torch import trace

    cfg, cell = _tiny_digest_ms()
    trace.enable()
    try:
        res = run_cell("digest_ms_values", seed, 0.5, True, device="cpu",
                       config=cfg, cell=cell, work=str(tmp_path / "w"))
        snap = trace.snapshot()
    finally:
        trace.disable()
    assert res["correct"], res["checks"]
    assert {k: c["value"] for k, c in res["checks"].items()} == {
        "report_lines_wrong": 0, "value_records_wrong": 0,
        "records_missing": 0, "calls_differing": 0}
    m = res["metrics"]
    assert m["layered_load_ms_per_call.values"]["value"] > 0
    assert 0 < m["pad_share.values"]["value"] < 100
    names = {s["name"] for s in snap["spans"]}
    assert {"load.layered", "load.fields", "load.text"} <= names
    assert snap["counters"]["symbols.past_index"] > 0
    checks = control.control_checks("digest_ms_values", seed, config=cfg,
                                    cell=cell)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def test_ms_report_runs_k3_k4_k5(tmp_path, monkeypatch):
    """A tiny `ms_report` run (pml_report's fixed 300-bp reads, `tiny`'s
    cut) is correct and its traced counters count K3, K4 and K5. On the
    CPU the wrappers run their plain versions and count no launch, so each
    is replaced by a stand-in that counts its calls as launches."""
    from benchmark import run
    from spumoni_tpu_torch import trace
    from spumoni_tpu_torch.engine import kernels

    def counted(fn):
        def call(*a, **k):
            fn.launches += 1
            return fn(*a, **k)
        return call

    for name in ("ms_scan", "ms_extend", "binmax_values"):
        monkeypatch.setattr(kernels, name, counted(getattr(kernels, name)))
    _, _, cfg, cell = run.cell_spec("ms_report")
    cfg = dict(cfg, strains=3, strain_len=30000)
    cell = dict(cell, reads=200, check_reads=80,
                length={"kind": "fixed", "bp": 300})
    kernels.reset_launch_counts()
    trace.enable()
    try:
        res = run_cell("ms_report", 2**34 + 3, 0.5, True, device="cpu",
                       config=cfg, cell=cell, work=str(tmp_path / "w"))
        counters = trace.snapshot()["counters"]
    finally:
        trace.disable()
        kernels.reset_launch_counts()
    assert res["correct"], res["checks"]
    assert "value_records_wrong" not in res["checks"]
    for name in ("ms_scan", "ms_extend", "binmax_values"):
        assert counters.get("launches." + name, 0) > 0, name
    assert 0 < res["metrics"]["load_share.report"]["value"] < 100
