"""The yardstick's arithmetic: bytes of a call, the readers, the trace's
interval reduction and the spans."""

import numpy as np
import pytest

from benchmark import readers, roofline
from benchmark.run import Readings, metric_names, reader
from benchmark.trace import DeviceTrace, Spans, merged


def test_scan_bytes():
    f = ["-P", "-c", "-n", "--report-only"]
    assert roofline.scan_bytes(f, 1000, 10) == 1000 * 33 + 160
    f = ["-P", "-c", "-n"]
    assert roofline.scan_bytes(f, 1000, 10) == 1000 * 33 + 4000
    f = ["-M", "-c", "-d", "-n"]
    assert roofline.scan_bytes(f, 1000, 10) == 2 * 1000 * 33 + 3 * 4000
    assert roofline.least_seconds(f, 1000, 10) == pytest.approx(
        (66000 + 12000) / 3.35e12)


def _ctx(**kw):
    base = dict(setup_s=20.0, window_s=10.0, bases_per_call=50_000_000,
                reads_per_call=1000, symbols_per_call=50_000_000,
                flags=["-P", "-c", "-n", "--report-only"],
                calls=[{"start": 0, "end": 5, "stream_s": 4.0},
                       {"start": 5, "end": 10, "stream_s": 4.5}])
    base.update(kw)
    return Readings(**base)


def test_readers():
    ctx = _ctx()
    assert readers.mbp_s(ctx) == pytest.approx(10.0)
    assert readers.load_share(ctx) == pytest.approx(15.0)
    assert readers.setup_s(ctx) == 20.0
    assert readers.input_ms_per_mbp(ctx) is None
    sp = Spans()
    sp.add("parse", 0.0, 0.5)
    sp.add("stage", 1.0, 1.25)
    sp.add("writer", 2.0, 3.0)
    ctx = _ctx(spans=sp)
    assert readers.input_ms_per_mbp(ctx) == pytest.approx(750 / 100)
    assert readers.writer_ms_per_mbp(ctx) == pytest.approx(1000 / 100)
    assert readers.digest_ms_per_mbp(ctx) is None
    assert readers.kernel_roofline(ctx) is None
    assert readers.device_idle_share(ctx) is None


def test_device_readers():
    dt = DeviceTrace([("k1", 1.0, 2.0), ("k2", 1.5, 2.5)],
                     [("Memcpy HtoD", 3.0, 3.5)], (0.0, 10.0))
    ctx = _ctx(device=dt)
    assert dt.busy_s() == pytest.approx(2.0)
    assert dt.kernel_s() == pytest.approx(2.0)
    assert readers.device_idle_share(ctx) == pytest.approx(80.0)
    least = 2 * 50_000_000 * 33 + 2 * 16 * 1000
    assert readers.kernel_roofline(ctx) == pytest.approx(
        100 * least / 3.35e12 / 2.0)
    assert dt.top_ops(2) == [["k1", 1.0], ["k2", 1.0]]
    sp = Spans()
    sp.add("parse", 4.0, 9.0)
    gaps = dt.idle_gaps(sp, 2)
    assert gaps[0] == ["parse", pytest.approx(6.5)]
    assert gaps[1] == ["none", pytest.approx(1.0)]


def test_merged_and_spans():
    iv = np.array([[3, 4], [0, 1], [0.5, 2], [4, 5]], float)
    assert merged(iv).tolist() == [[0, 2], [3, 5]]
    sp = Spans()
    sp.add("writer", 0.0, 1.0)
    sp.add("writer", 1.00001, 2.0)     # back to back: one interval
    sp.add("writer", 3.0, 4.0)
    assert sp.intervals["writer"] == [[0.0, 2.0], [3.0, 4.0]]
    assert sp.total["writer"] == pytest.approx(2.99999)


def test_wrappers_time_and_come_off():
    class Mod:
        @staticmethod
        def f(x):
            return x + 1

        @staticmethod
        def g(n):
            yield from range(n)

    sp = Spans()
    f0, g0 = Mod.f, Mod.g
    sp.wrap(Mod, "f", "writer")
    sp.wrap_generator(Mod, "g", "parse")
    assert Mod.f(1) == 2 and list(Mod.g(3)) == [0, 1, 2]
    assert len(sp.intervals["parse"]) >= 1 and "writer" in sp.total
    sp.remove()
    assert Mod.f is f0 and Mod.g is g0


def test_metric_selection():
    bench = {"end_to_end": [
        {"name": "a_s", "workloads": ["x"]}, {"name": "setup_s"}],
        "per_layer": [{"name": "m.a", "moves": "a_s", "workloads": ["x"]},
                      {"name": "m.b", "moves": "a_s"},
                      {"name": "m.c", "moves": "b_s"}]}
    assert metric_names(bench, "x", False) == ["a_s", "setup_s"]
    assert metric_names(bench, "x", True) == ["m.a", "m.b"]
    assert metric_names(bench, "y", False) == ["setup_s"]
    assert metric_names(bench, "y", True) == []


def test_reader_files_bind_readers():
    assert reader("load_share.values") is readers.load_share
    assert reader("report_mbp_s") is readers.mbp_s
