"""Host-side engine of the port: stages read batches onto the device and
runs the block-bits, layered or occ-block kernels over them.

Covers the surface of `spumoni_tpu/engine/scan_engine.py::ScanEngine` for
its block-bits, layered (`self.layered`) and occ-block (`self.occ`)
engines: `stage`, the growing staged alphabet, `classify_staged`,
`query_staged`, and the list API `classify` / `query`. Block-bits runs PML
on K1 / K2, MS on K3 pointers, K4 lengths and K5 bin-max, and document
tracking on K3; the layered engine runs PML on K7 / K8, MS and document
tracking on K7, then K4 and K5; the occ-block engine the same on K9 / K10
(the JAX package's v3 path, scan_engine.py:1861-1931).

Reads are bucketed by padded length (a power of two from PAD_TO up to
CHUNK, then multiples of CHUNK, as in the JAX package), packed REVERSED into
[B, L] uint8 rows by the native packer (8 bits per base: the 2- and 4-bit
transfer packings of the JAX package existed for the TPU host link), and
uploaded; MS runs also upload the raw forward rows for the extension.
Block-bits and occ-block rows are rank-mapped through the staged alphabet;
layered rows are raw bytes, since K7 / K8 read `charmeta[byte]` directly,
so the staged alphabet's 255-symbol limit does not bind them. Reads longer
than CHUNK go through the same kernels in one launch: the carry is per
lane, so no chunk state is kept (the occ-block scan resolves its one-step
lag per lane too).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _host
from . import kernels
from .blockbits import BlockBitsIndex, CharTable, alphabet_seed
from .layered import LayeredIndex
from .occblock import OccIndex

#: raw-byte staging of the forward rows (the MS extension compares bytes)
_IDENT_AMAP = np.arange(256, dtype=np.uint8)


class ScanEngine:
    PAD_TO = 128   # shortest bucket
    CHUNK = 4096   # longest power-of-two bucket; longer reads: multiples

    def __init__(self, index, table: CharTable = None, mode: str = "pml",
                 use_doc: bool = False):
        """index: a BlockBitsIndex or an OccIndex with its CharTable, or a
        LayeredIndex (no table)."""
        if mode not in ("pml", "ms"):
            raise ValueError(f"mode must be 'pml' or 'ms', not {mode!r}")
        self.layered = isinstance(index, LayeredIndex)
        self.occ = isinstance(index, OccIndex)
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
        self._stage_alpha = None   # cached, monotonically growing alphabet
        self._stage_amap = None    # its 256-byte LUT (255 = not covered)
        self._tabs: dict = {}      # alphabet -> table on self.device

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

    def _table(self, alphabet: tuple) -> torch.Tensor:
        tab = self._tabs.get(alphabet)
        if tab is None:
            tab = self._tabs[alphabet] = self.table.table_for_alphabet(
                alphabet).to(self.device)
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
        reversed packing (_pack_rev) and the copy to the device. Runs in
        the prefetch thread while the device works on the previous batch.
        Returns the staged groups that classify_staged / query_staged
        consume."""
        lens_all = np.asarray(packed.lens)
        if (lens_all == 0).any():
            i = int(np.flatnonzero(lens_all == 0)[0])
            raise ValueError(
                f"{packed.ids[i]} was empty after digestion; remove the read "
                f"or run without minimizer digestion")
        Lb = self._bucket_L(lens_all)
        offs, buf = packed.offs, packed.buf
        if not self.layered:
            self._ensure_alpha()
        groups = []
        for L in np.unique(Lb):
            L = int(L)
            idxs = np.flatnonzero(Lb == L)
            for c0 in range(0, len(idxs), max_lanes):
                sel = idxs[c0:c0 + max_lanes]
                lens = lens_all[sel].astype(np.int64)
                g = {"idxs": sel, "L": L, "lens": lens,
                     "rev_d": torch.from_numpy(self._pack_rev(
                         buf, offs[sel], offs[sel + 1], L)).to(self.device),
                     "lens_d": torch.from_numpy(lens).to(self.device)}
                if not self.layered:
                    g["tab"] = self._table(self._stage_alpha)
                if self.mode == "ms":
                    # raw bytes: the identity LUT's 255 "miss" is moot
                    fwd, _, _ = _host.pack_rows_native(
                        buf, offs[sel], offs[sel + 1], len(sel), L,
                        _IDENT_AMAP, False, 8)
                    g["fwd_d"] = torch.from_numpy(fwd).to(self.device)
                groups.append(g)
        return groups

    def _pack_rev(self, buf, starts, ends, L: int) -> np.ndarray:
        """[B, L] reversed rows: raw bytes for the layered engine,
        staged-alphabet ranks (extended and repacked on a miss) for
        block-bits."""
        B = len(starts)
        if self.layered:   # the identity LUT's 255 "miss" is moot
            return _host.pack_rows_native(buf, starts, ends, B, L,
                                          _IDENT_AMAP, True, 8)[0]
        rev, miss, _ = _host.pack_rows_native(buf, starts, ends, B, L,
                                              self._stage_amap, True, 8)
        if miss:   # a byte outside the alphabet: extend, repack
            self._extend_alpha(_host.present_chars(buf))
            rev, miss, _ = _host.pack_rows_native(buf, starts, ends, B, L,
                                                  self._stage_amap, True, 8)
        if miss:
            raise RuntimeError("staged alphabet misses a read byte")
        return rev

    # ------------------------------------------------------------------
    # device work
    # ------------------------------------------------------------------

    def _scan(self, g, mode: str, use_doc: bool):
        """(vals, docs) [B, L] on the device: K7 on the layered engine, K9
        on the occ-block engine, K3 on block-bits (MS, or PML with doc
        tracking)."""
        if self.layered:
            return kernels.layered_scan(self.index, g["rev_d"], g["lens_d"],
                                        mode, use_doc)
        if self.occ:
            return kernels.occ_scan(self.index, g["tab"], g["rev_d"],
                                    g["lens_d"], mode, use_doc)
        return kernels.ms_scan(self.index, g["tab"], g["rev_d"], g["lens_d"],
                               mode, use_doc)

    def _ms_values(self, g, use_doc: bool):
        """{'pointers', 'lengths'[, 'docs']} [B, L] on the device: the
        pointer scan (K7, K9 or K3), then K4 on its pointers."""
        ptrs, docs = self._scan(g, "ms", use_doc)
        mats = {"pointers": ptrs, "lengths": kernels.ms_extend(
            self.index.text, self.index.text_bound, g["fwd_d"], g["lens_d"],
            ptrs)}
        if use_doc:
            mats["docs"] = docs
        return mats

    def classify_staged(self, staged, bin_width: int, max_value_thr: int):
        """Per-read (found, above, below, sum_maxes) over staged groups, in
        the batch's read order. PML: K2, K8 on the layered engine or K10 on
        the occ-block engine; MS: K3, K7 or K9 -> K4 -> K5 (the port of
        _classify_ms_dev). Only [B] summaries leave the device."""
        if self.use_doc:
            raise ValueError("report-only classification is doc-free")
        n = sum(len(g["idxs"]) for g in staged)
        out = {"found": np.zeros(n, dtype=bool),
               "above": np.zeros(n, dtype=np.int64),
               "below": np.zeros(n, dtype=np.int64),
               "sum_maxes": np.zeros(n, dtype=np.int64)}
        for g in staged:
            if self.mode == "pml" and self.layered:
                res = kernels.layered_classify(self.index, g["rev_d"],
                                               g["lens_d"], max_value_thr,
                                               bin_width)
            elif self.mode == "pml" and self.occ:
                res = kernels.occ_classify(self.index, g["tab"], g["rev_d"],
                                           g["lens_d"], max_value_thr,
                                           bin_width)
            elif self.mode == "pml":
                res = kernels.pml_classify(self.index, g["tab"], g["rev_d"],
                                           g["lens_d"], max_value_thr,
                                           bin_width)
            else:
                res = kernels.binmax_values(
                    self._ms_values(g, False)["lengths"], g["lens_d"],
                    max_value_thr, bin_width)
            for key, v in zip(("found", "above", "below", "sum_maxes"), res):
                out[key][g["idxs"]] = v.cpu().numpy()
        return out

    def query_staged(self, staged) -> dict:
        """Per-read value arrays over staged groups, in the batch's read
        order: 'lengths' (PML: K1, or K3 with doc tracking, K7 on the
        layered engine, K9 on the occ-block engine; MS: K4), 'pointers' (MS:
        K3, K7 or K9) and 'docs' (doc tracking: K3, K7 or K9)."""
        n = sum(len(g["idxs"]) for g in staged)
        fields = ["pointers", "lengths"] if self.mode == "ms" else ["lengths"]
        if self.use_doc:
            fields.append("docs")
        out = {f: [None] * n for f in fields}
        for g in staged:
            if self.mode == "ms":
                mats = self._ms_values(g, self.use_doc)
            elif self.use_doc or self.layered or self.occ:
                lengths, docs = self._scan(g, "pml", self.use_doc)
                mats = {"lengths": lengths, "docs": docs}
            else:
                mats = {"lengths": kernels.pml_scan(
                    self.index, g["tab"], g["rev_d"], g["lens_d"])}
            for f in fields:
                vals = mats[f].cpu().numpy()
                for j, i in enumerate(g["idxs"]):
                    out[f][i] = vals[j, :g["lens"][j]]
        return out

    # ------------------------------------------------------------------
    # list API
    # ------------------------------------------------------------------

    def classify(self, reads, bin_width: int, max_value_thr: int,
                 max_lanes: int = 65536) -> dict:
        """Fused report-only classification of a list of byte-string
        reads."""
        return self.classify_staged(self.stage(_packed(reads), max_lanes),
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


def _packed(reads):
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(r) for r in reads], out=offs[1:])
    buf = np.frombuffer(b"".join(bytes(r) for r in reads), np.uint8)
    return _host.fastx_batch.PackedReads(
        [f"read_{i}" for i in range(len(reads))], buf, offs)
