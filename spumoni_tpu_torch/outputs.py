"""The files a `run` writes, and the thread that writes them.

`OutputSet` owns the output files of a run: their names for the mode, this
host's shard of each under SPUMONI_NUM_PROCESSES = P > 1, the durable read
cursor that `--resume` starts from, and the end of the run (the one
collective, then process 0's merge). `Writer` formats each batch into them
on a thread of its own, overlapped with the next batch's device work, and
commits it: every file flushed, then the cursor written. The order of
those two and the files' append modes are the `--resume` guarantee: a
cursor at k means this host's first k records are whole on disk.
"""

from __future__ import annotations

import itertools
import os
import queue
import threading
from collections import deque

from . import trace
from .classify import report
from .classify.values_writer import BatchIds, ValuesWriter
from .parallel import distributed as dist


class OutputSet:
    """This host's output files of the run that cfg (a RunConfig)
    describes: `.pseudo_lengths`, or `.lengths` and `.pointers`, then
    `.doc_numbers` with -d, and `.report` with -c; a general-text run
    writes the value files alone, a report-only run the report alone.
    `skip` is the records a resumed run finds durable."""

    def __init__(self, cfg):
        prefix = cfg.pattern_file
        self.P, self.p = cfg.process_count, cfg.process_index
        self.paths = {}
        if not cfg.report_only:
            if cfg.mode == "ms":
                self.paths["lengths"] = prefix + ".lengths"
                self.paths["pointers"] = prefix + ".pointers"
            else:
                self.paths["lengths"] = prefix + ".pseudo_lengths"
            if cfg.use_doc and not cfg.is_general_text:
                self.paths["docs"] = prefix + ".doc_numbers"
        if cfg.write_report:
            self.paths["report"] = prefix + ".report"
        # restartable streaming: the cursor records how many of this host's
        # records are durably written
        self.cursor = dist.shard_path(prefix + ".cursor", self.p, self.P)
        self.skip = 0
        if cfg.resume and os.path.exists(self.cursor):
            with open(self.cursor) as f:
                self.skip = int(f.read().strip() or 0)
        self.files: dict = {}
        self.header = None

    @property
    def value_files(self) -> list:
        return [f for k, f in self.files.items() if k != "report"]

    def open(self, header: str | None = None) -> None:
        """Opens this host's files, appended to on resume, else new; the
        report gets `header` at P = 1 when new (a shard's report has none:
        process 0's merge writes it)."""
        mode = "a" if self.skip else "w"
        self.header = header
        self.files = {k: open(dist.shard_path(v, self.p, self.P),
                              mode + ("" if k == "report" else "b"))
                      for k, v in self.paths.items()}
        if "report" in self.files and self.P == 1 and not self.skip:
            self.files["report"].write(header)

    def commit(self, num: int) -> None:
        """Makes the first `num` records durable: flushes every file, then
        writes the cursor."""
        for f in self.files.values():
            f.flush()
        with open(self.cursor, "w") as f:
            f.write(str(num))

    def close(self) -> None:
        for f in self.files.values():
            f.close()

    @property
    def merges(self) -> bool:
        """Whether finish() merges the hosts' shards here."""
        return self.P > 1 and self.p == 0

    def finish(self, found: int, num: int) -> tuple[int, int]:
        """Ends the run after close(): removes the cursor; under P > 1 the
        one collective, the all-gather of the (found, num) counts, which is
        the barrier before process 0 merges the shards into the files one
        process writes (spumoni_tpu/pipeline.py:1118-1132). Returns the
        counts over every host."""
        if os.path.exists(self.cursor):
            os.remove(self.cursor)
        if self.P == 1:
            return found, num
        found, num = dist.global_found_counts(found, num)
        if self.merges:
            for k, v in self.paths.items():
                dist.merge_shards(v, self.P, header=self.header
                                  if k == "report" else None)
        return found, num


def _mean(total, above: int, below: int) -> float:
    return total / (above + below)


def _mean_of_any(total, above: int, below: int) -> float:
    """_mean, 0 for a read with no bin (shorter than the window)."""
    return total / max(above + below, 1)


def _report_lines(f, ids, above, below, totals, mean, line,
                  found=None) -> int:
    """Writes a report line a read: `line` of its verdict, `mean` of its
    total, and its bins (or KS windows) above and below the threshold. The
    verdict is `found` where given, else FOUND when more than half are
    above. Returns the FOUND count."""
    hits = 0
    for i, rid in enumerate(ids):
        a, b = above[i], below[i]
        hit = found[i] if found is not None else a / (a + b) > 0.50
        hits += hit
        f.write(line(rid, "FOUND" if hit else "NOT_PRESENT",
                     mean(totals[i], a, b), a, b))
    return hits


class Writer:
    """The writer thread (named `writer`) of a run over `outputs`: each
    batch `put` hands it is formatted into the files and committed, in
    order. A batch is ids and either the engine's per-read values
    (query_staged's fields) or, with report_only, its verdicts
    (classify_staged's). The value files go through one ValuesWriter; with
    `bins` = (bin_width, max_value_thr) the lengths' pass also gives the
    bin-max report, with `ks_test` (a KSTest) the report is the KS test's,
    its rand() advanced before each read's test by the draws the feed
    appended to `ks_pending`. Counts the FOUND reads and the reads
    written, from outputs.skip; an error stops the thread, and result()
    raises it."""

    def __init__(self, outputs: OutputSet, *, report_only: bool = False,
                 bins=None, ks_test=None):
        self.outputs = outputs
        self.report_only = report_only
        self.bins = bins
        self.ks_test = ks_test
        # per yielded read, the draws owed before its test (read_feed)
        self.ks_pending = deque() if ks_test is not None else None
        self.values = ValuesWriter() if outputs.value_files else None
        self.found, self.num, self.error = 0, outputs.skip, None
        self._q: queue.Queue = queue.Queue(maxsize=2)
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="writer")
        self._thread.start()

    def put(self, ids, out) -> bool:
        """Hands a batch to the thread; False once it has stopped on an
        error, the batch not taken."""
        if self.error is not None:
            return False
        with trace.span("feed.wait_writer"):
            return self._offer((ids, out))

    def close(self) -> None:
        """Ends the thread after the batches it took."""
        with trace.span("run.drain"):
            self._offer(None)
            self._thread.join()

    def result(self) -> tuple[int, int]:
        """(FOUND reads, reads written) after close(); raises the error
        that stopped the thread."""
        if self.error is not None:
            raise self.error
        return self.found, self.num

    def _offer(self, item) -> bool:
        while self._thread.is_alive():   # a writer that failed takes no more
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _loop(self) -> None:
        try:
            for b in itertools.count():   # items arrive in batch order
                with trace.span("writer.wait", batch=b):
                    item = self._q.get()
                if item is None:
                    return
                trace.set_batch(b)
                with trace.span("writer.batch"):
                    self._write(*item)
        except Exception as e:  # raised by result() after the drain
            self.error = e

    def _write(self, ids, out) -> None:
        value_files = self.outputs.value_files
        # the value text a batch writes: the files' growth, buffer included
        at = (sum(f.tell() for f in value_files)
              if value_files and trace.recording() else None)
        with trace.span("writer.format"):
            if self.report_only:
                self.found += _report_lines(
                    self.outputs.files["report"], ids, out["above"].tolist(),
                    out["below"].tolist(), out["sum_maxes"].tolist(),
                    _mean_of_any, report.report_line, out["found"].tolist())
            else:
                self._values(ids, out, value_files)
        if at is not None:
            trace.count("value_bytes",
                        sum(f.tell() for f in value_files) - at)
        self.num += len(ids)
        with trace.span("writer.flush"):
            self.outputs.commit(self.num)

    def _values(self, ids, out, value_files) -> None:
        # one pass a value file, in the JAX package's writer order
        # (spumoni_tpu/pipeline.py:971-977); the lengths' pass gives the
        # bin-max verdicts
        files = self.outputs.files
        bids = BatchIds(ids)
        for k in ("docs", "pointers"):
            if k in files:
                self.values.write(files[k], bids, out[k])
        res = self.values.write(files["lengths"], bids, out["lengths"],
                                self.bins)
        trace.count("value_records", len(ids) * len(value_files))
        if self.ks_test is not None:
            ks, thr = self.ks_test, self.ks_test.null_db.ks_stat_threshold
            above, below, totals = [], [], []
            for lengths in out["lengths"]:
                ks.rand.advance(self.ks_pending.popleft())
                stats = ks.run_kstest(lengths)
                a = sum(1 for x in stats if x >= thr)
                above.append(a)
                below.append(len(stats) - a)
                totals.append(sum(stats))
            self.found += _report_lines(files["report"], ids, above, below,
                                        totals, _mean, report.ks_report_line)
        elif res is not None:
            above, below, totals = (a.tolist() for a in res)
            self.found += _report_lines(files["report"], ids, above, below,
                                        totals, _mean, report.report_line)
