"""The comparison fails what it must: the control (the reference with the
thresholds' tie reversed, in the program's place) and a run whose timed
path is broken underneath come out as not correct. The harness's look for
a card is skipped (`device="cpu"`); the rest of a run is driven as is.
A cell on one card has no exchange between chips to leave out."""

import numpy as np
import pytest

from benchmark import control, run
from conftest import CELLS, tiny


@pytest.mark.parametrize("traffic", CELLS)
def test_control_is_not_correct(traffic):
    workload, cfg, cell = tiny(traffic)
    checks = control.control_checks(workload, 2**34 + 5, cfg, cell)
    assert any(c["value"] > c["limit"] for c in checks.values()), checks


def _unchanged(monkeypatch):
    """Every scan returns its start state: lengths 0, no bin above."""
    from spumoni_tpu_torch.engine.scan_engine import ScanEngine

    q0, c0 = ScanEngine.query_staged, ScanEngine.classify_staged

    def query(self, staged):
        out = q0(self, staged)
        out["lengths"] = [np.zeros_like(v) for v in out["lengths"]]
        return out

    def classify(self, staged, bw, thr):
        out = c0(self, staged, bw, thr)
        out["below"] += out["above"]
        for k in ("found", "above", "sum_maxes"):
            out[k][:] = 0
        return out

    monkeypatch.setattr(ScanEngine, "query_staged", query)
    monkeypatch.setattr(ScanEngine, "classify_staged", classify)


def _half_batch(monkeypatch):
    """Half of each batch's reads never reach the engine or the files."""
    from spumoni_tpu_torch.io import fastx_batch

    it0 = fastx_batch.iter_packed_batches

    def half(*a, **k):
        for pk in it0(*a, **k):
            yield fastx_batch.select_records(
                pk, np.arange(0, len(pk), 2, dtype=np.int64))

    monkeypatch.setattr(fastx_batch, "iter_packed_batches", half)


def _altered(monkeypatch):
    """One answer of each read altered where the engine produces it."""
    from spumoni_tpu_torch.engine.scan_engine import ScanEngine

    q0, c0 = ScanEngine.query_staged, ScanEngine.classify_staged

    def query(self, staged):
        out = q0(self, staged)
        for v in out["lengths"]:
            v[len(v) // 2] += 1
        return out

    def classify(self, staged, bw, thr):
        out = c0(self, staged, bw, thr)
        out["sum_maxes"] += 1
        return out

    monkeypatch.setattr(ScanEngine, "query_staged", query)
    monkeypatch.setattr(ScanEngine, "classify_staged", classify)


def _flaky(monkeypatch):
    """The scans of _unchanged, in every other call only (the window keeps
    every call's report, and only the last call's value files)."""
    from spumoni_tpu_torch.engine.scan_engine import ScanEngine

    calls = {"n": 0}
    q0, c0 = ScanEngine.query_staged, ScanEngine.classify_staged
    _unchanged(monkeypatch)
    q1, c1 = ScanEngine.query_staged, ScanEngine.classify_staged
    from spumoni_tpu_torch import cli

    r0 = cli.run

    def counted(cfg):
        calls["n"] += 1
        return r0(cfg)

    monkeypatch.setattr(cli, "run", counted)
    monkeypatch.setattr(ScanEngine, "query_staged", lambda s, st: (
        q1 if calls["n"] % 2 else q0)(s, st))
    monkeypatch.setattr(ScanEngine, "classify_staged", lambda s, st, b, t: (
        c1 if calls["n"] % 2 else c0)(s, st, b, t))


# the number each fault must fail (the others may fail too)
FAULTS = [(_unchanged, None), (_half_batch, "records_missing"),
          (_altered, None), (_flaky, "calls_differing")]


@pytest.mark.parametrize("fault,number", FAULTS)
@pytest.mark.parametrize("traffic", CELLS)
def test_broken_path_is_not_correct(traffic, fault, number, monkeypatch,
                                    tmp_path):
    workload, cfg, cell = tiny(traffic)
    fault(monkeypatch)
    # _flaky needs two calls in the window; the long reads' plain scans
    # take several seconds a call on the CPU
    seconds = 10.0 if fault is _flaky and traffic == "pml_values_long" \
        else 1.0
    res = run.run_cell(workload, 2**34 + 9, seconds, False, device="cpu",
                       config=cfg, cell=cell, work=str(tmp_path / "w"))
    assert not res["correct"], res["checks"]
    if number:
        c = res["checks"][number]
        assert c["value"] > c["limit"], res["checks"]
