"""The units of the port's run loop, without an engine: the output set
(outputs.OutputSet: file names, shard paths, open modes, the header rule,
the cursor that `commit` writes and `--resume` reads, and `finish`'s
merge), the read feed (feed.read_feed on a stub `stage`: host stride,
resume and the KS rand() draws each read owes, against a per-record loop)
and the writer thread (outputs.Writer: a batch it cannot format stops it,
and the run loop drains, does not hang, and raises that error)."""

import os
import threading
from collections import deque

import numpy as np
import pytest

from spumoni_tpu_torch.classify import kstest
from spumoni_tpu_torch.feed import read_feed
from spumoni_tpu_torch.io import fastx_batch, minimizers
from spumoni_tpu_torch.outputs import OutputSet, Writer
from spumoni_tpu_torch.pipeline import RunConfig

HEADER = "read id: header\n"

#: mode -> (RunConfig flags, the files' keys and extensions)
MODES = {
    "pml-c": (dict(pml_requested=True, write_report=True),
              {"lengths": ".pseudo_lengths", "report": ".report"}),
    "ms-d": (dict(ms_requested=True, use_doc=True),
             {"lengths": ".lengths", "pointers": ".pointers",
              "docs": ".doc_numbers"}),
    "report-only": (dict(pml_requested=True, write_report=True,
                         report_only=True), {"report": ".report"}),
    # general text has no report and no -d, whatever the flags say
    "general": (dict(ms_requested=True, use_doc=True, is_general_text=True,
                     min_digest=False),
                {"lengths": ".lengths", "pointers": ".pointers"}),
}


def _record(key, name):
    """One record of the file `key`: a value record, or a report line."""
    return f"{name}\n" if key == "report" else f">{name}\n1 2 \n"


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("resume", [False, True], ids=["new", "resume"])
@pytest.mark.parametrize("P", [1, 2])
def test_output_set(tmp_path, mode, resume, P):
    """Each host's files: their names and open modes, the header at P = 1
    on a new report only, the cursor a committed batch writes and a
    resumed run starts from, and finish(): the cursor gone, host 0's merge
    in global record order with the header."""
    flags, exts = MODES[mode]
    prefix = str(tmp_path / "reads.fa")

    def cfg(p, resume):
        return RunConfig(pattern_file=prefix, resume=resume,
                         process_index=p, process_count=P, **flags)

    def shard(path, p):
        return path if P == 1 else f"{path}.shard{p:04d}"

    sets = []
    for p in range(P):
        # a cursor at 3 + p and its durable records, from an earlier run:
        # read with --resume, else the files start anew
        with open(shard(prefix + ".cursor", p), "w") as f:
            f.write(str(3 + p))
        for k, e in exts.items():
            with open(shard(prefix + e, p), "w") as f:
                f.write((HEADER if k == "report" and P == 1 else "")
                        + _record(k, f"old{p}"))
        out = OutputSet(cfg(p, resume))
        assert out.paths == {k: prefix + e for k, e in exts.items()}
        assert out.cursor == shard(prefix + ".cursor", p)
        assert out.skip == (3 + p if resume else 0)
        out.open(HEADER)
        assert {k: f.name for k, f in out.files.items()} == \
            {k: shard(prefix + e, p) for k, e in exts.items()}
        for k, f in out.files.items():
            assert f.mode == ("a" if resume else "w") + \
                ("" if k == "report" else "b")
            f.write(_record(k, f"new{p}") if k == "report"
                    else _record(k, f"new{p}").encode())
        out.commit(out.skip + 1)
        for k, e in exts.items():   # flushed before the cursor
            with open(shard(prefix + e, p)) as f:
                assert f.read().endswith(_record(k, f"new{p}"))
        assert OutputSet(cfg(p, True)).skip == out.skip + 1
        out.close()
        sets.append(out)
    assert [o.merges for o in sets] == [P > 1 and p == 0 for p in range(P)]
    for out in reversed(sets):    # host 0 merges after the others closed
        assert out.finish(1, out.skip + 1) == (1, out.skip + 1)
        assert not os.path.exists(out.cursor)
    for k, e in exts.items():
        with open(prefix + e) as f:
            got = f.read()
        # once: open()'s at P = 1, the earlier run's on resume, the merge's
        head = HEADER if k == "report" else ""
        old = "".join(_record(k, f"old{p}") for p in range(P)) \
            if resume else ""
        assert got == head + old + "".join(_record(k, f"new{p}")
                                           for p in range(P))
        assert not any(os.path.exists(shard(prefix + e, p))
                       for p in range(P) if P > 1)


LENGTHS = [60, 333, 128, 51, 260, 90, 410, 150, 75, 199, 301, 64, 120]


@pytest.fixture(scope="module")
def reads_file(tmp_path_factory):
    rng = np.random.default_rng(5)
    path = str(tmp_path_factory.mktemp("feed") / "reads.fa")
    with open(path, "w") as f:
        for i, n in enumerate(LENGTHS):
            seq = "".join("ACGT"[j] for j in rng.integers(0, 4, n))
            f.write(f">r{i}\n{seq}\n")
    return path


class _Stage:
    """engine.stage's stand-in: the ids and lengths it was handed."""

    def __init__(self):
        self.lanes = set()

    def stage(self, pk, max_lanes):
        self.lanes.add(max_lanes)
        return list(pk.ids), pk.lens.tolist()


@pytest.mark.parametrize("ks,digest", [(False, False), (True, False),
                                       (True, True)],
                         ids=["values", "ks", "ks-digested"])
@pytest.mark.parametrize("skip", [0, 2, 5, 40])
@pytest.mark.parametrize("P,p,report_only", [(1, 0, False), (2, 0, True),
                                             (3, 2, False)],
                         ids=["P1", "P2-host0-report-only", "P3-host2"])
def test_read_feed(reads_file, P, p, report_only, skip, ks, digest):
    """The reads a host yields after `skip`, batch by batch, their bases
    and (digested) symbols, and with KS the draws each owes: those of
    every record between it and the previous yielded read, against a loop
    over the records one by one."""
    cfg = RunConfig(pattern_file=reads_file, batch_bases=700, bin_size=50,
                    process_index=p, process_count=P, report_only=report_only,
                    min_digest=digest, use_promotions=digest)
    whole = next(fastx_batch.iter_packed_batches(reads_file, 1 << 30,
                                                 upper=True))
    symbols = (minimizers.digest_packed(whole, True, False, cfg.k, cfg.w)
               if digest else whole).lens.tolist()
    want_ids, want_owes, carry, own = [], [], 0, 0
    for i, rid in enumerate(whole.ids):
        mine = i % P == p and own >= skip
        own += i % P == p
        if mine:
            want_ids.append(rid)
            want_owes.append(carry)
            carry = 0
        else:
            carry += kstest.n_windows(symbols[i], cfg.bin_size)
    pending = deque() if ks else None
    stage = _Stage()
    got = list(read_feed(cfg, stage, skip, pending))
    ids = [rid for b in got for rid in b[0]]
    assert ids == want_ids
    assert all(list(b[0]) == b[1][0] for b in got)
    idx = [whole.ids.index(rid) for rid in ids]
    assert [n for b in got for n in b[1][1]] == [symbols[i] for i in idx]
    assert sum(b[2] for b in got) == sum(LENGTHS[i] for i in idx)
    assert sum(b[3] for b in got) == sum(symbols[i] for i in idx)
    if ks:
        assert list(pending) == want_owes
    assert stage.lanes == ({65536 if report_only else 8192} if ids
                           else set())


@pytest.mark.parametrize("fail_at", [0, 1, 4])
@pytest.mark.parametrize("mode", ["values", "report-only"])
def test_writer_error_stops_the_run(tmp_path, mode, fail_at):
    """A batch the writer cannot format (rows that do not pair with the
    ids, or verdicts without their sums) ends the thread: `put` takes no
    more, the loop of `run` drains without hanging, the batches before it
    stay committed, and result() raises the error."""
    report_only = mode == "report-only"
    flags = (dict(pml_requested=True, write_report=True, report_only=True)
             if report_only else dict(pml_requested=True))
    outputs = OutputSet(RunConfig(pattern_file=str(tmp_path / "r.fa"),
                                  **flags))
    outputs.open(HEADER)
    writer = Writer(outputs, report_only=report_only)

    def batch(b):
        ids = [f"b{b}_{i}" for i in range(3)]
        if report_only:
            out = {"found": np.array([True, False, True]),
                   "above": np.array([2, 0, 1]),
                   "below": np.array([1, 3, 0]),
                   "sum_maxes": np.array([40, 9, 17])}
            if b == fail_at:
                del out["sum_maxes"]
        else:
            out = {"lengths": [np.arange(i + 1, dtype=np.int32)
                               for i in range(2 if b == fail_at else 3)]}
        return ids, out

    taken = []

    def loop():                  # _run's loop, the engine's output made up
        try:
            for b in range(50):
                if not writer.put(*batch(b)):
                    break
                taken.append(b)
        finally:
            writer.close()
            outputs.close()

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive()
    # the queue holds two batches: the loop runs at most that far ahead
    assert fail_at in taken and len(taken) <= fail_at + 4
    with pytest.raises(KeyError if report_only else ValueError):
        writer.result()
    assert writer.num == 3 * fail_at
    if fail_at:
        with open(outputs.cursor) as f:
            assert f.read() == str(3 * fail_at)
    else:
        assert not os.path.exists(outputs.cursor)
    ext = ".report" if report_only else ".pseudo_lengths"
    with open(str(tmp_path / "r.fa") + ext) as f:
        text = f.read()
    names = [f"b{b}_{i}" for b in range(fail_at) for i in range(3)]
    assert [w for w in text.split() if w.lstrip(">").startswith("b")
            and "_" in w] == [(">" if not report_only else "") + n
                              for n in names]
