"""The read feed of `run`: the batches a host streams to the device.

`read_feed` parses the query file in batches, keeps the records this host
owns (the host stride under SPUMONI_NUM_PROCESSES = P > 1), drops the ones
a resumed run already wrote, digests them and stages them for the engine;
with `--ks-report` it also counts the glibc rand() draws each yielded read
owes for the records before it that it does not yield. `general_text_feed`
is the same for a general-text file's \\x01-separated records, which are
not staged. `prefetched` runs a feed on a thread of its own, ahead of the
device work.
"""

from __future__ import annotations

import itertools
import queue
import threading

import numpy as np

from . import trace
from .classify import kstest
from .io import fasta, fastx_batch, minimizers
from .parallel import distributed as dist


def prefetched(gen, depth: int = 2):
    """Runs `gen` in a daemon thread, keeping up to `depth` items ready —
    host FASTA decode + digestion overlap device compute (SURVEY.md §7.8;
    the role of the reference's threaded BatchLoader). Item b is the
    tracer's batch b on both threads."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    SENTINEL = object()

    def producer():
        try:
            for b in itertools.count():
                trace.set_batch(b)
                item = next(gen, SENTINEL)
                with trace.span("prefetch.wait_consumer"):
                    q.put(item)
                if item is SENTINEL:
                    return
        except BaseException as e:  # surface errors on the consumer side
            q.put(e)

    threading.Thread(target=producer, daemon=True, name="prefetch").start()
    for b in itertools.count():
        with trace.span("feed.wait_input", batch=b):
            item = q.get()
        if item is SENTINEL:
            trace.set_batch(None)
            return
        if isinstance(item, BaseException):
            raise item
        trace.set_batch(b)
        yield item


def _digested(cfg, pk):
    if not cfg.min_digest:
        return pk
    with trace.span("prefetch.digest"):
        return minimizers.digest_packed(
            pk, cfg.use_promotions, cfg.use_dna_letters, cfg.k, cfg.w)


def read_feed(cfg, engine, skip: int, ks_pending=None):
    """Yields (ids, staged, bases, symbols) a batch of cfg.pattern_file:
    the records this host owns after the `skip` it already wrote, staged
    by engine.stage, their input bases and the bases or digested symbols
    staged. With a deque `ks_pending` (--ks-report), appends to it, per
    yielded read, the rand() draws of the records between it and the
    previous yielded read, one per KS window of the digested record."""
    # host-stride sharding (spumoni_tpu/pipeline.py:1018-1082): every
    # host parses the whole file and keeps the records it owns (global
    # index % P == p); the cursor counts owned records
    P, p = cfg.process_count, cfg.process_index
    g = 0            # global record index at the batch's start
    owned_seen = 0   # owned records seen (the cursor's units)
    ks_carry = 0     # rand() draws owed for records not yielded
    # a report-only group fetches [B] verdicts, a value group [B, L] values
    max_lanes = 65536 if cfg.report_only else 8192
    batches = fastx_batch.iter_packed_batches(cfg.pattern_file,
                                              cfg.batch_bases, upper=True)
    while True:
        with trace.span("prefetch.parse"):
            pk = next(batches, None)
        if pk is None:
            return
        npk = len(pk)
        in_lens = pk.lens    # input bases, before digestion
        first = (p - g) % P          # the batch's first owned record
        g += npk
        nown = -(-(npk - first) // P) if first < npk else 0
        csum = None
        if ks_pending is not None:
            # one draw per KS window of the DIGESTED read, for every
            # record of the batch (spumoni_tpu/pipeline.py:1040-1050)
            pk = _digested(cfg, pk)
            nw = kstest.n_windows_batch(pk.lens, cfg.bin_size)
            csum = np.zeros(npk + 1, dtype=np.int64)
            np.cumsum(nw, out=csum[1:])
        if owned_seen + nown <= skip:   # resume: skip whole batches
            owned_seen += nown
            if csum is not None:
                ks_carry += int(csum[npk])
            continue
        a = max(0, skip - owned_seen)   # owned records already durable
        owned_seen += nown
        sel = np.arange(first, npk, P, dtype=np.int64)[a:]
        if len(sel) == 0:
            if csum is not None:
                ks_carry += int(csum[npk])
            continue
        if csum is not None:
            # per yielded read: the draws of the records between it and
            # the previous yielded one (advanced before its test)
            gaps = np.empty(len(sel), dtype=np.int64)
            gaps[0] = ks_carry + csum[sel[0]]
            gaps[1:] = csum[sel[1:]] - csum[sel[:-1] + 1]
            ks_carry = int(csum[npk] - csum[sel[-1] + 1])
            ks_pending.extend(int(v) for v in gaps)
        if P > 1:
            pk = fastx_batch.select_records(pk, sel)
        elif a:                          # resume: a partial batch
            pk = fastx_batch.PackedReads(
                pk.ids[a:], pk.buf[pk.offs[a]:].copy(),
                (pk.offs[a:] - pk.offs[a]).copy())
        if ks_pending is None:
            pk = _digested(cfg, pk)
        bases = int(in_lens[sel].sum())
        trace.count("reads", len(pk))
        trace.count("bases", bases)
        trace.count("symbols", pk.total_bases)
        with trace.span("prefetch.stage"):
            staged = engine.stage(pk, max_lanes)
        yield pk.ids, staged, bases, pk.total_bases


def general_text_feed(cfg, skip: int):
    """Yields (ids, reads, bases, bases) a batch of a general-text
    cfg.pattern_file (spumoni_tpu/pipeline.py:1141-1201): the \\x01-
    separated records (compute_ms_pml.cpp:1219-1297) this host owns after
    the `skip` it already wrote, as byte strings, in batches of about
    cfg.batch_bases bytes. Records may be empty, so they are not staged:
    engine.query takes the list."""
    records = (item for own, (_, item) in enumerate(dist.host_shard_reads(
        fasta.iter_general_reads(cfg.pattern_file), cfg.process_index,
        cfg.process_count)) if own >= skip)
    for batch in fasta.batch_iter(records, cfg.batch_bases):
        reads = [rd for _, rd in batch]
        bases = sum(map(len, reads))
        yield [rid for rid, _ in batch], reads, bases, bases
