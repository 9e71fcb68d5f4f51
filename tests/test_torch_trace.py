"""The port's tracer (spumoni_tpu_torch/trace.py) on `run` with
device='cpu': nothing recorded while it is off; with it on, each thread's
spans, nested in their parents and sharing (call, batch) across the three
threads; the per-batch counters against the fixture's reads; the Chrome
trace that SPUMONI_TRACE writes; a run under torch.profiler."""

import json
import os

import numpy as np
import pytest
import torch

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch import trace
from spumoni_tpu_torch.io import fastx_batch, minimizers

LENGTHS = (100, 129, 200, 300, 520, 700, 90, 260, 1100, 400)
BATCH_BASES = 1200        # several batches of the reads above

MAIN = {"run", "run.load", "load.null_db", "load.files", "feed.wait_input",
        "device.launch", "device.fetch", "feed.wait_writer", "run.drain"}
PREFETCH = {"prefetch.parse", "prefetch.stage", "prefetch.wait_consumer"}
WRITER = {"writer.wait", "writer.batch", "writer.format", "writer.flush"}


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """-n and -m PML indexes of a 12-kbp genome, and reads of LENGTHS (bp)
    drawn from it with a few substitutions."""
    tmp = tmp_path_factory.mktemp("trace")
    rng = np.random.default_rng(7)
    genome = "".join("ACGT"[i] for i in rng.integers(0, 4, 12000))
    ref = str(tmp / "genome.fa")
    with open(ref, "w") as f:
        f.write(">chr1\n" + genome + "\n")
    reads = str(tmp / "reads.fa")
    seqs = []
    with open(reads, "w") as f:
        for i, n in enumerate(LENGTHS):
            st = int(rng.integers(0, len(genome) - n))
            rd = list(genome[st:st + n])
            for k in rng.integers(0, n, n // 50):
                rd[k] = "ACGT"[(("ACGT".index(rd[k])) + 1) % 4]
            seqs.append("".join(rd))
            f.write(f">read_{i}\n{seqs[-1]}\n")
    out = {}
    for key, kw in (("n", dict(use_minimizers=False)),
                    ("m", dict(use_promotions=True))):
        prefix = str(tmp / f"idx_{key}")
        tpl.build(tpl.BuildConfig(ref_file=ref, output_prefix=prefix,
                                  pml_index=True, **kw))
        out[key] = dict(ref_file=prefix, pattern_file=reads,
                        pml_requested=True, device="cpu",
                        batch_bases=BATCH_BASES,
                        **({"min_digest": False} if key == "n"
                           else {"use_promotions": True}))
    out["seqs"] = seqs
    out["short"] = str(tmp / "short.fa")    # one read, one short scan
    with open(out["short"], "w") as f:
        f.write(f">read_0\n{seqs[0][:60]}\n")
    return out


@pytest.fixture
def tracer():
    trace.enable()
    yield trace
    trace.disable()
    trace.clear()


def _run(base, **kw):
    return tpl.run(tpl.RunConfig(**base, **kw))


def _by_name(snap):
    out = {}
    for s in snap["spans"]:
        out.setdefault(s["name"], []).append(s)
    return out


def test_off_records_nothing(indexes):
    trace.disable()
    trace.clear()
    assert trace.span("device.fetch") is trace.span("run") is trace.NO_SPAN
    trace.count("reads", 5)
    assert trace.launches() is None
    _run(indexes["n"], write_report=True)
    snap = trace.snapshot()
    assert snap["spans"] == [] and snap["counts"] == []
    assert snap["anchors"] == []


@pytest.mark.parametrize("report_only", [False, True])
def test_spans_of_each_thread(indexes, tracer, report_only):
    _run(indexes["n"], write_report=True, report_only=report_only)
    snap = tracer.snapshot()
    threads = {}
    for s in snap["spans"]:
        threads.setdefault(s["thread"], set()).add(s["name"])
    main = threads.pop("MainThread")
    want_main = MAIN | ({"device.split"} if not report_only else set())
    assert want_main <= main, want_main - main
    assert threads["prefetch"] == PREFETCH
    assert threads["writer"] == WRITER
    # children inside their parents, on their parents' thread
    by_id = {s["id"]: s for s in snap["spans"]}
    for s in snap["spans"]:
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["thread"] == s["thread"]
            assert p["start"] <= s["start"] <= s["end"] <= p["end"], (p, s)
    names = _by_name(snap)
    assert len(names["run"]) == 1 and names["run"][0]["parent"] is None
    assert {names[k][0]["parent"] for k in ("run.load", "run.drain")} == \
        {names["run"][0]["id"]}
    # one (call, batch) per batch on all three threads
    keys = {k: {(s["call"], s["batch"]) for s in names[k]}
            for k in ("prefetch.stage", "device.fetch", "writer.batch",
                      "feed.wait_writer")}
    nb = len(names["prefetch.stage"])
    assert nb >= 3
    call = names["run"][0]["call"]
    assert all(v == {(call, b) for b in range(nb)} for v in keys.values())
    assert {s["call"] for s in snap["spans"]} == {call}


@pytest.mark.parametrize("key", ["n", "m"])
def test_counters(indexes, tracer, key):
    base = indexes[key]
    _run(base, write_report=True)
    seqs = indexes["seqs"]
    c = tracer.snapshot()["counters"]
    assert c["reads"] == len(seqs)
    assert c["bases"] == sum(len(s) for s in seqs)
    if key == "m":
        pk = next(fastx_batch.iter_packed_batches(base["pattern_file"],
                                                  1 << 30, upper=True))
        lens = minimizers.digest_packed(pk, True, False, 4, 11).lens
        assert c["symbols"] < c["bases"]
    else:
        lens = np.array([len(s) for s in seqs])
    assert c["symbols"] == int(lens.sum())
    # lanes x the padded length: powers of two from 128 (all under 4,096)
    assert c["lanes"] == len(seqs)
    padded = [max(128, 1 << int(np.ceil(np.log2(n)))) for n in lens]
    assert c["slots"] == sum(padded)
    assert 1 - c["symbols"] / c["slots"] == pytest.approx(
        sum(p - n for n, p in zip(lens, padded)) / sum(padded))
    assert c["groups"] >= len(set(padded))
    assert c["htod_bytes"] > c["symbols"] // 4
    assert c["dtoh_bytes"] >= 4 * c["slots"]   # one value matrix at least
    # the plain versions launch no kernel
    assert not any(k.startswith("launches.") for k in c)
    st = tpl.LAST_RUN_STATS
    assert (st["reads"], st["bases"], st["symbols"]) == (
        c["reads"], c["bases"], c["symbols"])


def test_chrome_trace_file(indexes, tmp_path, monkeypatch):
    trace.disable()
    trace.clear()
    path = str(tmp_path / "run.json")
    monkeypatch.setenv(trace.ENV, path)
    _run(indexes["n"], write_report=True, report_only=True)
    with open(path) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert MAIN | PREFETCH | WRITER - {"device.split"} <= names
    threads = {e["args"]["name"] for e in doc["traceEvents"]
               if e["ph"] == "M"}
    assert {"MainThread", "prefetch", "writer"} <= threads
    assert doc["otherData"]["counters"]["reads"] == len(LENGTHS)
    assert [a["call"] for a in doc["otherData"]["anchors"]] == [
        doc["traceEvents"][0]["args"]["call"]]
    # a second call writes its own records only
    _run(indexes["n"], write_report=True, report_only=True)
    with open(path) as f:
        again = json.load(f)
    calls = {e["args"]["call"] for e in again["traceEvents"]
             if e["ph"] == "X"}
    assert len(calls) == 1 and len(again["otherData"]["anchors"]) == 1
    assert again["otherData"]["counters"]["reads"] == len(LENGTHS)
    monkeypatch.delenv(trace.ENV)
    trace.clear()
    _run(indexes["n"], write_report=True, report_only=True)
    assert trace.snapshot()["spans"] == []


def test_chrome_trace_a_file_a_host(indexes, tmp_path, monkeypatch):
    """Two hosts simulated in one process (host 1, then host 0, which
    merges): one trace file each, their reads adding up to the file's."""
    trace.disable()
    path = str(tmp_path / "run.json")
    monkeypatch.setenv(trace.ENV, path)
    for p in (1, 0):
        _run(indexes["n"], write_report=True, report_only=True,
             process_index=p, process_count=2)
    reads = []
    for p in (0, 1):
        with open(f"{path}.shard{p:04d}") as f:
            reads.append(json.load(f)["otherData"]["counters"]["reads"])
    assert not os.path.exists(path)
    assert sorted(reads) == [len(LENGTHS) // 2] * 2
    trace.clear()


def test_a_profiled_run_records(indexes):
    """A call that starts under torch.profiler records its spans, and the
    profiler sees the tracer's clock anchor."""
    from torch.profiler import ProfilerActivity, profile

    trace.disable()
    trace.clear()
    base = dict(indexes["n"], pattern_file=indexes["short"])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _run(base, write_report=True, report_only=True)
    snap = trace.snapshot()
    assert {"run", "feed.wait_input", "writer.batch"} <= \
        {s["name"] for s in snap["spans"]}
    assert len(snap["anchors"]) == 1
    mark = [e for e in prof.events() if e.name == trace.ANCHOR]
    assert len(mark) == 1
    run = [s for s in snap["spans"] if s["name"] == "run"][0]
    assert snap["anchors"][0]["call"] == run["call"]
    assert snap["anchors"][0]["t"] <= run["start"]
    _run(base, write_report=True, report_only=True)
    assert len(trace.snapshot()["spans"]) == len(snap["spans"])
    trace.clear()
    assert torch.autograd.profiler._is_profiler_enabled is False


def test_outputs_unchanged_by_tracing(indexes, tracer):
    base = indexes["m"]
    _run(base, write_report=True)
    got = {e: open(base["pattern_file"] + e, "rb").read()
           for e in (".pseudo_lengths", ".report")}
    tracer.disable()
    _run(base, write_report=True)
    for e, data in got.items():
        assert open(base["pattern_file"] + e, "rb").read() == data
    assert not os.path.exists(base["pattern_file"] + ".cursor")


def test_threads_record_every_span(tracer):
    """Many threads on a short switch interval: no span or count is lost,
    ids stay unique, and each span's parent is its own thread's."""
    import sys
    import threading

    n_threads, n = 16, 400

    def work(b):
        tracer.set_batch(b)
        for _ in range(n):
            with tracer.span("writer.batch"):
                with tracer.span("writer.format"):
                    tracer.count("lanes", 1)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(b,), name=f"t{b}")
                   for b in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tracer.snapshot()
    spans = snap["spans"]
    assert len(spans) == 2 * n_threads * n
    assert len({s["id"] for s in spans}) == len(spans)
    assert snap["counters"]["lanes"] == n_threads * n
    by_id = {s["id"]: s for s in spans}
    for s in spans:
        assert s["batch"] == int(s["thread"][1:])
        if s["name"] == "writer.format":
            assert by_id[s["parent"]]["thread"] == s["thread"]
        else:
            assert s["parent"] is None
