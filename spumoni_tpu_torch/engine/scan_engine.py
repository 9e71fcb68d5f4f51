"""Host-side engine of the port: stages read batches onto the device and
runs the block-bits, layered or occ-block kernels over them.

Covers the surface of `spumoni_tpu/engine/scan_engine.py::ScanEngine` for
its block-bits, layered (`self.layered`) and occ-block (`self.occ`)
engines: `stage`, the growing staged alphabet, `classify_staged`,
`query_staged`, and the list API `classify` / `query`. Block-bits runs PML
on K1 / K2, MS on K3 pointers, K4 lengths and K5 bin-max, and document
tracking on K3; the layered engine runs PML on K7 / K8, MS and document
tracking on K7, then K4 and K5; the occ-block engine the same on K9 / K10
(the JAX package's v3 path, scan_engine.py:1861-1931). A sharded index
(parallel/tp.py, `run --tp-devices S`) runs report-only PML on K13
(block-bits) or K14 (layered), and MS values, with or without doc ids, on
K15 then K16 (block-bits).

Reads are bucketed by padded length (a power of two from PAD_TO up to
CHUNK, then multiples of CHUNK, as in the JAX package) and packed REVERSED
into rows by the native packer, at the bits the JAX package's staged path
picks (scan_engine.py:1700-1763): 2 bits per base (A, C, G, T codes, every
other byte a sparse (row, col, value) exception) when the exception list
fits, else 4 bits (a staged alphabet of at most 16 symbols) or 8. The
packed rows are uploaded, and K11 (`unpack2`) or K12 (`unpack4`) decodes
them on the device into the [B, L] uint8 rows the scans read, 0 past each
read, the same bytes the 8-bit rows hold. MS runs also upload the forward
rows as raw bytes for the extension: at 2 bits with the identity values,
or at 4 bits as ranks that K12 maps back to bytes through the group's
alphabet. Block-bits and occ-block rows are rank-mapped through the staged
alphabet; layered rows are raw bytes, since K7 / K8 read `charmeta[byte]`
directly, so the staged alphabet's 255-symbol limit does not bind them;
they go at 2 bits with the identity values or at 8. A raw row holding byte
255 goes at 8 bits: the packer's identity map reports that byte as a miss
and lists no exceptions for it (ROADMAP section C). Reads longer than CHUNK
go through the same kernels in one launch: the carry is per lane, so no
chunk state is kept (the occ-block scan resolves its one-step lag per lane
too).

On block-bits (`grouped`), a value batch's staged groups on one device run
in one grouped launch of K1, or of K3 then K4 (kernels.Lanes): stage lays
the groups' decoded rows out one after another in one flat tensor and
uploads each lane's row offset, length and output offset, the longest
reads first; query_staged decodes every group into its place, launches
once and fetches each field's values, flat and unpadded in the batch's
read order, with one copy. The layered, occ-block and sharded engines, and
classify_staged, launch once a group.

`to_devices` makes an engine data-parallel, as the JAX package's `to_mesh`
does over a mesh's `data` axis: each staged group's lanes are cut into one
contiguous slice per listed device (a device may repeat), each slice
uploaded to its device and scanned there on that device's copy of the
index (or its placed shards), every slice's kernels launched before any
output is fetched, and the outputs merged back in lane order.
"""
from __future__ import annotations

import copy
import itertools

import numpy as np
import torch

from .. import trace
from ..io.fastx_batch import PackedReads
from ..native import pack_rows_native
from ..parallel.tp import ShardedBlockBits, ShardedLayered
from ..utils import present_chars
from . import kernels
from .blockbits import BlockBitsIndex, CharTable, alphabet_seed
from .layered import LayeredIndex
from .occblock import OccIndex

#: raw-byte staging (layered rows, the MS extension's forward rows)
_IDENT_AMAP = np.arange(256, dtype=np.uint8)
#: the bytes of the 2-bit codes 0-3, and the packer's map to them (255: the
#: byte is an exception)
_ACGT = tuple(b"ACGT")
_AMAP2_ACGT = np.full(256, 255, np.uint8)
_AMAP2_ACGT[list(_ACGT)] = np.arange(4, dtype=np.uint8)
#: the longest row staged at 2 bits: exception columns are int32 in the
#: native packer
_MAX_EXC_COL = 2**31 - 1


class ScanEngine:
    PAD_TO = 128   # shortest bucket
    CHUNK = 4096   # longest power-of-two bucket; longer reads: multiples

    def __init__(self, index, table: CharTable = None, mode: str = "pml",
                 use_doc: bool = False):
        """index: a BlockBitsIndex, ShardedBlockBits or OccIndex with its
        CharTable, or a LayeredIndex or ShardedLayered (no table)."""
        if mode not in ("pml", "ms"):
            raise ValueError(f"mode must be 'pml' or 'ms', not {mode!r}")
        self.sharded = isinstance(index, (ShardedBlockBits, ShardedLayered))
        self.layered = isinstance(index, (LayeredIndex, ShardedLayered))
        self.occ = isinstance(index, OccIndex)
        #: value batches in one grouped launch a device (block-bits)
        self.grouped = not (self.sharded or self.layered or self.occ)
        if self.layered or self.occ:
            has_ms, has_doc = index.meta.has_samples, index.meta.has_doc
        else:
            has_ms = index.jump_t is not None
            has_doc = index.jump_d is not None
        if mode == "ms" and not (has_ms and index.text is not None):
            raise ValueError("MS needs an index built with want_ms from a "
                             "dense index with SA samples and text (build -M)")
        if use_doc and not has_doc:
            raise ValueError("doc tracking needs an index built with "
                             "want_doc (build -d)")
        self.index = index
        self.table = table
        self.mode = mode
        self.use_doc = use_doc
        self.device = (index.charmeta if self.layered else index.blocks
                       if self.occ else index.bblocks).device
        self.devices = [self.device]   # one lane slice of a group each
        self._indexes = [index]        # the index devices[k] reads
        self._stage_alpha = None   # cached, monotonically growing alphabet
        self._stage_amap = None    # its 256-byte LUT (255 = not covered)
        self._tabs: dict = {}      # (alphabet, device) -> table there
        self._groups = itertools.count()   # ids of staged groups
        #: the layered index's last symbol (the bytes after it leave the
        #: BWT: counter `symbols.past_index`)
        self._last = (int(index.charmeta[:, 1].nonzero().max())
                      if self.layered else None)

    def to_devices(self, devices, indexes=None) -> "ScanEngine":
        """Makes this engine data-parallel over `devices` (the JAX
        package's ScanEngine.to_mesh, scan_engine.py:1263-1275): stage cuts
        each group's lanes into len(devices) contiguous slices, slice k on
        devices[k]; classify_staged and query_staged launch every slice's
        kernels before fetching any output. `indexes[k]` is the index
        devices[k]'s launches read (default: this engine's index, one copy
        on each distinct device; a sharded index with its shards placed
        across cards by parallel/tp.py::place_shards). A device may repeat
        (its slices then share one copy)."""
        devices = [torch.device(d) for d in devices]
        if not devices:
            raise ValueError("to_devices needs at least one device")
        if indexes is None:
            copies = {self.device: self.index}
            indexes = [copies[d] if d in copies else copies.setdefault(
                d, _index_on(self.index, d)) for d in devices]
        if len(indexes) != len(devices):
            raise ValueError(f"{len(indexes)} indexes for {len(devices)} "
                             f"devices")
        self.devices, self._indexes = devices, list(indexes)
        return self

    # ------------------------------------------------------------------
    # the staged alphabet: a superset alphabet is always correct (absent
    # characters carry their own cnt/F), so it only grows
    # ------------------------------------------------------------------

    def _ensure_alpha(self):
        if self._stage_alpha is None:
            self._stage_alpha = tuple(sorted(alphabet_seed(self.table)))
            self._stage_amap = self._build_amap255(self._stage_alpha)

    def _extend_alpha(self, present):
        alpha = tuple(sorted(set(self._stage_alpha)
                             | set(int(x) for x in present)))
        if len(alpha) >= 255:
            raise ValueError("alphabet too large for the staged path")
        self._stage_alpha = alpha
        self._stage_amap = self._build_amap255(alpha)

    @staticmethod
    def _build_amap255(alphabet: tuple) -> np.ndarray:
        amap = np.full(256, 255, np.uint8)
        for i, c in enumerate(alphabet):
            amap[c] = i
        return amap

    def _table(self, alphabet: tuple, device: torch.device) -> torch.Tensor:
        tab = self._tabs.get((alphabet, device))
        if tab is None:
            tab = self._tabs[alphabet, device] = \
                self.table.table_for_alphabet(alphabet).to(device)
        return tab

    # ------------------------------------------------------------------
    # staging
    # ------------------------------------------------------------------

    def _bucket_L(self, m: np.ndarray) -> np.ndarray:
        m = np.maximum(m, 1)
        p2 = (2 ** np.ceil(np.log2(m))).astype(np.int64)
        return np.where(m > self.CHUNK, -(-m // self.CHUNK) * self.CHUNK,
                        np.clip(p2, self.PAD_TO, self.CHUNK))

    def stage(self, packed, max_lanes: int = 65536) -> list:
        """Host prep + device upload for one PackedReads batch: bucketing,
        packing at 2, 4 or 8 bits (_pack) and the copy to the device. Runs
        in the prefetch thread while the device works on the previous
        batch. Returns the staged groups that classify_staged /
        query_staged consume; each carries its bits, its 2-bit values
        (`ranks2`) and its alphabet, which later batches may extend. On a
        data-parallel engine (to_devices) each group is cut into one
        staged part per device, lanes in order, all with the group's
        `group` id; part k carries `replica` k. A grouped engine stages
        every group of a batch in one alphabet and lays each device's
        parts out for one grouped launch (_lay_out). Counts (trace.py) the
        batch's staged groups, lanes, lane slots (lanes x L) and the bytes
        uploaded, and on the layered engine, only while the tracer records,
        the read symbols that sort after every index symbol."""
        lens_all = np.asarray(packed.lens)
        if self._last is not None and trace.recording():
            trace.count("symbols.past_index", np.count_nonzero(
                packed.buf[:packed.total_bases] > self._last))
        if (lens_all == 0).any():
            i = int(np.flatnonzero(lens_all == 0)[0])
            raise ValueError(
                f"{packed.ids[i]} was empty after digestion; remove the read "
                f"or run without minimizer digestion")
        Lb = self._bucket_L(lens_all)
        if not self.layered:
            self._ensure_alpha()
        packs = []
        for L in np.unique(Lb):
            idxs = np.flatnonzero(Lb == L)
            packs += [self._pack(packed, idxs[c0:c0 + max_lanes], int(L))
                      for c0 in range(0, len(idxs), max_lanes)]
        if self.grouped:
            # a grouped launch reads every group through one table: the
            # groups packed before the batch grew the alphabet, packed
            # again in the alphabet it grew to (no byte of the batch
            # misses it now); nothing is uploaded before this
            packs = [p if p["alpha"] == self._stage_alpha
                     else self._pack(packed, p["idxs"], p["L"])
                     for p in packs]
        groups = []
        lanes = slots = htod = 0
        for p in packs:
            sel, L, lens = p.pop("idxs"), p["L"], p.pop("lens")
            rows, exc = p.pop("rows"), p.pop("exc")
            fwd, fexc = p.pop("fwd", None), p.pop("fexc", None)
            gid = next(self._groups)
            lanes += len(sel)
            slots += len(sel) * L
            htod += rows.nbytes + lens.nbytes + _nbytes(exc)
            if fwd is not None:
                htod += fwd.nbytes + _nbytes(fexc)
            for k, (lo, hi) in enumerate(_slices(len(sel),
                                                 len(self.devices))):
                if lo == hi:
                    continue
                dev = self.devices[k]
                g = dict(p, idxs=sel[lo:hi], lens=lens[lo:hi],
                         rev_p=_put(rows[lo:hi], dev),
                         exc_d=_put(_exc_rows(exc, lo, hi, len(sel)), dev),
                         lens_d=_put(lens[lo:hi], dev), group=gid, replica=k)
                if not self.layered:
                    g["tab"] = self._table(p["alpha"], dev)
                if fwd is not None:
                    g.update(fwd_p=_put(fwd[lo:hi], dev),
                             fexc_d=_put(_exc_rows(fexc, lo, hi, len(sel)),
                                         dev))
                groups.append(g)
        if self.grouped:
            for parts in _by_device(groups):
                htod += self._lay_out(parts)
        trace.count("groups", len(packs))
        trace.count("lanes", lanes)
        trace.count("slots", slots)
        trace.count("htod_bytes", htod)
        return groups

    def _lay_out(self, parts) -> int:
        """Lays one device's staged parts of a batch out for one grouped
        launch: part g's decoded rows at g['at'] bytes into the
        device's flat rows, its reads' values at g['offs'] of the flat
        outputs (each read's in the batch's read order, no padding), and
        the device's kernels.Lanes, uploaded here, as g['lanes'] of every
        part. Returns the bytes uploaded."""
        at = 0
        for g in parts:
            g["at"] = at
            at += len(g["idxs"]) * g["L"]
        idxs = np.concatenate([g["idxs"] for g in parts])
        lens = np.concatenate([g["lens"] for g in parts])
        rows = np.concatenate([g["at"] + np.arange(len(g["idxs"])) * g["L"]
                               for g in parts])
        order = np.argsort(idxs, kind="stable")     # read order
        offs = np.empty_like(lens)
        offs[order] = np.cumsum(lens[order]) - lens[order]
        first = np.argsort(-lens, kind="stable")    # longest first
        desc = np.ascontiguousarray(np.stack([rows, lens, offs])[:, first])
        lanes = kernels.Lanes(_put(desc, self.devices[parts[0]["replica"]]),
                              int(lens.sum()), int(lens.max()), len(parts))
        cuts = np.cumsum([len(g["idxs"]) for g in parts])[:-1]
        for g, goffs in zip(parts, np.split(offs, cuts)):
            g.update(offs=goffs, lanes=lanes)
        return desc.nbytes

    def _pack(self, packed, sel, L: int) -> dict:
        """One group's rows packed on the host: the batch's reads `sel` at
        width L, reversed (_pack_rev; raw bytes at 2 bits on the layered
        engine) and, for MS, forward (the extension's input). The keys of
        a staged group, with the host arrays `rows`, `exc`, `lens` and, for
        MS, `fwd`, `fexc` in place of their uploads."""
        buf, starts, ends = packed.buf, packed.offs[sel], packed.offs[sel + 1]
        p = {"idxs": sel, "L": L,
             "lens": np.asarray(packed.lens)[sel].astype(np.int64)}
        if self.layered:
            p["bits"], p["rows"], p["exc"] = _pack_raw(buf, starts, ends, L,
                                                       True, 2)
            p.update(ranks2=_ACGT, alpha=None)
        else:
            p["bits"], p["rows"], p["exc"] = self._pack_rev(buf, starts,
                                                            ends, L)
            p.update(alpha=self._stage_alpha, ranks2=tuple(
                int(self._stage_amap[c]) for c in _ACGT))
        if self.mode == "ms":
            if p["bits"] == 4:   # ranks, mapped back to bytes by K12
                p.update(fwd_bits=4, fexc=None, fwd=pack_rows_native(
                    buf, starts, ends, len(sel), L, self._stage_amap, False,
                    4)[0])
            else:
                p["fwd_bits"], p["fwd"], p["fexc"] = _pack_raw(
                    buf, starts, ends, L, False, p["bits"])
        return p

    def _pack_rev(self, buf, starts, ends, L: int):
        """(bits, packed reversed rows, exceptions) in staged-alphabet ranks,
        by the JAX package's rule (scan_engine.py:1702-1727): 2 bits first;
        a byte outside the staged alphabet extends it and packs again; when
        the exception list overflows (cap = max(1024, B * L / 64)), 4 bits
        for an alphabet of at most 16 symbols, else 8. exceptions is a
        [k, 3] int32 array at 2 bits when k > 0, else None."""
        B = len(starts)
        bits = 2 if L <= _MAX_EXC_COL else 4
        extended = False
        while True:
            if bits == 4 and len(self._stage_alpha) > 16:
                bits = 8
            rows, miss, exc = pack_rows_native(buf, starts, ends, B, L,
                                               self._stage_amap, True, bits,
                                               _AMAP2_ACGT)
            if miss:   # a byte outside the alphabet: extend, repack
                if extended:
                    raise RuntimeError("staged alphabet misses a read byte")
                self._extend_alpha(present_chars(buf))
                extended = True
                continue
            if bits == 2 and exc is None:   # the exception list overflowed
                bits = 4
                continue
            return bits, rows, exc if exc is not None and len(exc) else None

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _rev_d(self, g, out=None) -> torch.Tensor:
        """[B, L] uint8 reversed rows of a staged group on the device: K11
        decodes 2-bit rows through the group's ranks2 and exceptions, K12
        4-bit rows; 8-bit rows are used as uploaded. Written into `out`
        where given (the group's place in a grouped launch's flat rows)."""
        if g["bits"] == 2:
            return kernels.unpack2(g["rev_p"], g["ranks2"], g["exc_d"],
                                   g["lens_d"], out)
        if g["bits"] == 4:
            return kernels.unpack4(g["rev_p"], g["lens_d"], out=out)
        return g["rev_p"] if out is None else out.copy_(g["rev_p"])

    def _fwd_d(self, g, out=None) -> torch.Tensor:
        """[B, L] uint8 raw forward rows (the MS extension's input) on the
        device: K11 with the identity values, K12 through the group's
        alphabet (rank -> byte), or the 8-bit rows as uploaded; into `out`
        where given."""
        if g["fwd_bits"] == 2:
            return kernels.unpack2(g["fwd_p"], _ACGT, g["fexc_d"],
                                   g["lens_d"], out)
        if g["fwd_bits"] == 4:
            return kernels.unpack4(g["fwd_p"], g["lens_d"],
                                   _alpha_table(g["alpha"]), out)
        return g["fwd_p"] if out is None else out.copy_(g["fwd_p"])

    def _flat_rows(self, parts, decode) -> torch.Tensor:
        """A grouped launch's flat rows: each part's decoded [B, L] rows
        (`decode`: _rev_d or _fwd_d) at its place, g['at']."""
        last = parts[-1]
        flat = torch.empty(last["at"] + len(last["idxs"]) * last["L"],
                           dtype=torch.uint8,
                           device=self.devices[last["replica"]])
        for g in parts:
            n = len(g["idxs"]) * g["L"]
            decode(g, flat[g["at"]:g["at"] + n].view(-1, g["L"]))
        return flat

    def _index(self, g):
        """The index the staged part g's launches read (its device's)."""
        return self._indexes[g["replica"]]

    def _scan(self, g, rev, mode: str, use_doc: bool):
        """(vals, docs) [B, L] on the device for the group's decoded rows
        `rev`: K7 on the layered engine, K9 on the occ-block engine, K3 on
        block-bits (MS, or PML with doc tracking), K15 on sharded
        block-bits."""
        index = self._index(g)
        if self.sharded:
            if self.layered:
                raise ValueError("a sharded layered index serves "
                                 "report-only PML only")
            return kernels.ms_scan_tp(index, g["tab"], rev, g["lens_d"],
                                      mode, use_doc)
        if self.layered:
            return kernels.layered_scan(index, rev, g["lens_d"], mode,
                                        use_doc)
        if self.occ:
            return kernels.occ_scan(index, g["tab"], rev, g["lens_d"], mode,
                                    use_doc)
        return kernels.ms_scan(index, g["tab"], rev, g["lens_d"], mode,
                               use_doc)

    def _ms_values(self, g, rev, use_doc: bool):
        """{'pointers', 'lengths'[, 'docs']} [B, L] on the device: the
        pointer scan (K7, K9 or K3), then K4 on its pointers and the
        decoded forward rows."""
        ptrs, docs = self._scan(g, rev, "ms", use_doc)
        extend = kernels.ms_extend_tp if self.sharded else kernels.ms_extend
        index = self._index(g)
        mats = {"pointers": ptrs, "lengths": extend(
            index.text, index.text_bound, self._fwd_d(g), g["lens_d"], ptrs)}
        if use_doc:
            mats["docs"] = docs
        return mats

    def classify_staged(self, staged, bin_width: int, max_value_thr: int):
        """Per-read (found, above, below, sum_maxes) over staged groups, in
        the batch's read order. PML: K2, K8 on the layered engine or K10 on
        the occ-block engine, K13 / K14 on a sharded index; MS: K3, K7 or
        K9 -> K4 -> K5 (the port of _classify_ms_dev). Only [B] summaries
        leave the device; the parts of a group on several devices are all
        launched before any is fetched. Spans (trace.py) `device.launch`
        and `device.fetch` a round of parts; counts the bytes fetched and
        each kernel's launches."""
        if self.use_doc:
            raise ValueError("report-only classification is doc-free")
        n = sum(len(g["idxs"]) for g in staged)
        out = {"found": np.zeros(n, dtype=bool),
               "above": np.zeros(n, dtype=np.int64),
               "below": np.zeros(n, dtype=np.int64),
               "sum_maxes": np.zeros(n, dtype=np.int64)}
        before, fetched = trace.launches(), 0
        for parts in _rounds(staged):
            with trace.span("device.launch"):
                launched = [(g, self._classify(g, bin_width, max_value_thr))
                            for g in parts]
            with trace.span("device.fetch"):
                for g, res in launched:
                    for key, v in zip(("found", "above", "below",
                                       "sum_maxes"), res):
                        host = v.cpu().numpy()
                        fetched += host.nbytes
                        out[key][g["idxs"]] = host
        trace.count("dtoh_bytes", fetched)
        trace.count_launches(before)
        return out

    def _classify(self, g, bin_width: int, max_value_thr: int):
        """The staged part g's (found, above, below, sum_maxes) on its
        device, launched, not fetched."""
        rev = self._rev_d(g)
        index = self._index(g)
        if self.mode == "pml" and self.layered:
            classify = (kernels.layered_classify_tp if self.sharded
                        else kernels.layered_classify)
            return classify(index, rev, g["lens_d"], max_value_thr,
                            bin_width)
        if self.mode == "pml" and self.occ:
            return kernels.occ_classify(index, g["tab"], rev, g["lens_d"],
                                        max_value_thr, bin_width)
        if self.mode == "pml":
            classify = (kernels.pml_classify_tp if self.sharded
                        else kernels.pml_classify)
            return classify(index, g["tab"], rev, g["lens_d"],
                            max_value_thr, bin_width)
        return kernels.binmax_values(
            self._ms_values(g, rev, False)["lengths"], g["lens_d"],
            max_value_thr, bin_width)

    def query_staged(self, staged) -> dict:
        """Per-read value arrays over staged groups, in the batch's read
        order: 'lengths' (PML: K1, or K3 with doc tracking, K7 on the
        layered engine, K9 on the occ-block engine; MS: K4, K16 on a sharded
        index), 'pointers' (MS: K3, K7, K9 or K15) and 'docs' (doc tracking:
        K3, K7, K9 or K15). A sharded index has no PML value scan. On a
        grouped engine each device's parts go in one grouped launch
        (_grouped_values), else each part in its own. Every launch of a round (a grouped launch a device, or a
        group's parts) is made before any is fetched. Spans
        `device.launch` a round, `device.fetch` and `device.split` (the
        cut into per-read arrays) a launch; counts as classify_staged
        does."""
        n = sum(len(g["idxs"]) for g in staged)
        fields = ["pointers", "lengths"] if self.mode == "ms" else ["lengths"]
        if self.use_doc:
            fields.append("docs")
        out = {f: [None] * n for f in fields}
        before, fetched = trace.launches(), 0
        if self.grouped:
            rounds, launch = [_by_device(staged)], self._grouped_values
        else:
            rounds = ([[g] for g in parts] for parts in _rounds(staged))
            launch = self._values
        for launches in rounds:
            with trace.span("device.launch"):
                launched = [(parts, launch(parts)) for parts in launches]
            for parts, mats in launched:
                with trace.span("device.fetch"):
                    host = {f: _fetched(mats[f]) for f in fields}
                fetched += sum(v.nbytes for v in host.values())
                with trace.span("device.split"):
                    for f in fields:
                        for g in parts:
                            _split(g, host[f], out[f])
        trace.count("dtoh_bytes", fetched)
        trace.count_launches(before)
        return out

    def _values(self, parts) -> dict:
        """A staged part's value matrices on its device ([g]: one part),
        launched, not fetched: the layered, occ-block and sharded
        engines."""
        (g,) = parts
        rev = self._rev_d(g)
        if self.mode == "ms":
            return self._ms_values(g, rev, self.use_doc)
        if self.sharded and not self.use_doc:
            raise ValueError("a sharded index serves PML values only with "
                             "doc ids (report-only PML: classify_staged)")
        lengths, docs = self._scan(g, rev, "pml", self.use_doc)
        return {"lengths": lengths, "docs": docs}

    def _grouped_values(self, parts) -> dict:
        """One device's laid-out parts of a value batch (_lay_out) in one
        grouped launch of K1 (PML), or K3 (MS, PML with doc ids) and then
        K4 (MS) on K3's pointers: the parts decoded by K11 / K12 into the
        flat rows, the values flat in the batch's read order; launched, not
        fetched. Counts the staged groups each launch serves
        (`scan.groups`)."""
        lanes = parts[0]["lanes"]
        index, tab = self._index(parts[0]), parts[0]["tab"]
        rev = self._flat_rows(parts, self._rev_d)
        if self.mode == "pml" and not self.use_doc:
            mats = {"lengths": kernels.pml_scan(index, tab, rev, lanes)}
        else:
            vals, docs = kernels.ms_scan(index, tab, rev, lanes, self.mode,
                                         self.use_doc)
            mats = {"pointers" if self.mode == "ms" else "lengths": vals,
                    "docs": docs}
        trace.count("scan.groups", lanes.groups)
        if self.mode == "ms":
            mats["lengths"] = kernels.ms_extend(
                index.text, index.text_bound,
                self._flat_rows(parts, self._fwd_d), lanes, mats["pointers"])
            trace.count("scan.groups", lanes.groups)
        return mats

    # ------------------------------------------------------------------
    # list API
    # ------------------------------------------------------------------

    def classify(self, reads, bin_width: int, max_value_thr: int,
                 max_lanes: int = 65536) -> dict:
        """Fused report-only classification of a list of byte-string
        reads."""
        return self.classify_staged(
            self.stage(_packed(reads), max_lanes),
            bin_width, max_value_thr)

    def query(self, reads, max_lanes: int = 8192) -> dict:
        """Per-read value arrays (query_staged's fields) for a list of
        byte-string reads; an empty read gets empty arrays (general-text
        records may be empty)."""
        keep = [i for i, rd in enumerate(reads) if len(rd)]
        out = self.query_staged(self.stage(_packed([reads[i] for i in keep]),
                                           max_lanes))
        full = {}
        for f, vals in out.items():
            full[f] = [np.zeros(0, np.int64)] * len(reads)
            for j, i in enumerate(keep):
                full[f][i] = vals[j]
        return full


def _index_on(index, device: torch.device):
    """A copy of the index module with every buffer on `device` (the
    module's own `.to` would move it in place)."""
    return copy.deepcopy(index, memo={id(t): t.to(device)
                                      for t in index.buffers()})


def _slices(B: int, parts: int) -> list:
    """[lo, hi) of `parts` contiguous lane slices of B lanes, in order,
    sizes differing by at most one (empty where B < parts)."""
    return [(k * B // parts, (k + 1) * B // parts) for k in range(parts)]


def _exc_rows(exc, lo: int, hi: int, B: int):
    """The [k, 3] (row, col, byte) exceptions of rows [lo, hi) of B, rows
    counted from lo; None where there are none."""
    if exc is None or (lo, hi) == (0, B):
        return exc
    part = exc[(exc[:, 0] >= lo) & (exc[:, 0] < hi)]
    if not len(part):
        return None
    part = part.copy()
    part[:, 0] -= lo
    return part


def _nbytes(a) -> int:
    return 0 if a is None else a.nbytes


def _put(a, device: torch.device):
    """A host array on `device`; None (no exceptions) stays None."""
    return None if a is None else torch.from_numpy(a).to(device)


def _rounds(staged):
    """The staged parts in runs of one group each (one part per device)."""
    return (list(parts) for _, parts in itertools.groupby(
        staged, key=lambda g: g["group"]))


def _by_device(staged) -> list:
    """The staged parts of each device (replica), in staged order."""
    parts: dict = {}
    for g in staged:
        parts.setdefault(g["replica"], []).append(g)
    return list(parts.values())


def _fetched(t: torch.Tensor) -> np.ndarray:
    """t's values on the host. A CUDA tensor comes through a pinned buffer,
    which PyTorch's caching host allocator keeps for the next batch's. A
    grouped launch's flat values (123 MB a field in a 2,048-read value
    call) fetched into fresh pageable memory took 3.4 times as long a
    byte as one launch a group's 27 smaller fetches (H100 80GB HBM3
    host): past glibc's 32 MB mmap threshold each fetch maps new pages
    and faults on every one."""
    if t.device.type != "cuda":
        return t.numpy()
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    return host.numpy()


def _split(g, vals: np.ndarray, out: list) -> None:
    """Part g's reads' values into out (read index -> array): views of a
    grouped launch's flat values at the part's offsets, or the rows of its
    [B, L] matrix cut to each read's length."""
    if "offs" in g:
        for i, o, n in zip(g["idxs"], g["offs"], g["lens"]):
            out[i] = vals[o:o + n]
    else:
        for j, i in enumerate(g["idxs"]):
            out[i] = vals[j, :g["lens"][j]]


def _pack_raw(buf, starts, ends, L: int, reverse: bool, bits: int):
    """(bits, packed rows, exceptions) of raw-byte rows: with bits=2, 2 bits
    with the identity values (A, C, G, T; every other byte an exception)
    unless the exception list overflows or a read holds byte 255, which the
    identity map reports as a miss with no exception (the JAX package then
    decodes it as A, ROADMAP section C); else 8 bits."""
    B = len(starts)
    if bits == 2 and L <= _MAX_EXC_COL:
        rows, miss, exc = pack_rows_native(buf, starts, ends, B, L,
                                           _IDENT_AMAP, reverse, 2,
                                           _AMAP2_ACGT)
        if not miss and exc is not None:
            return 2, rows, exc if len(exc) else None
    return 8, pack_rows_native(buf, starts, ends, B, L, _IDENT_AMAP, reverse,
                               8)[0], None


def _alpha_table(alpha: tuple) -> tuple:
    """K12's 16-entry table of a staged alphabet of at most 16 symbols:
    rank -> raw byte, 0 past the alphabet (_decode_alpha)."""
    return tuple(alpha) + (0,) * (16 - len(alpha))


def _packed(reads):
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    buf = np.frombuffer(b"".join(bytes(r) for r in reads), np.uint8)
    return PackedReads(
        [f"read_{i}" for i in range(len(reads))], buf, offs)
