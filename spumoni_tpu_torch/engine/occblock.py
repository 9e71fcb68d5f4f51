"""Occ-block index (engine v3 layout) for the PyTorch port.

Host side of `spumoni_tpu/engine/occblock.py`: an FM-index occ-checkpoint
layout that serves a backward step from ONE row. Every P BWT positions
(P a power of two, 128 by default) one int32 row holds

    [0, 16)          cp[rank] = F[char] + occ(char, block_start)
    [16, T0)         the block's build ranks, 4-bit packed, nibble 0 the
                     previous block's last character (prevchar; 15 in block 0
                     and in the padding)
    [T0, T0 + P)     thr: the threshold of the run holding occurrence
                     (p - F[c]) of c, indexed by F-space position p
    [S0, S0 + 2P)    MS: samples_start by p, samples_last shifted by one
    [D0, D0 + 2P)    -d: doc ids (sdoc by p, edoc shifted by one)

so rank(pos, c), bwt[pos] and the threshold of the candidate's run come
from the row of one position. The jump decision is deferred one step: a
step carries the unresolved candidate and resolves it from the row the next
step reads anyway, so MS samples and doc ids resolve one step late (PML
lengths in-step); see the JAX module's docstring for the derivation from
compute_ms_pml.cpp:237-286 and :570-682.

`eligible` keeps the layout's own bounds, sigma <= 15 (4-bit ranks, 15 the
padding) and n < 2^31 (int32 rows), and drops the JAX package's
n <= 128 * 2^17: that is the TPU's gather cliff at 2^17 rows, and a GPU
thread reads a row by direct index at any row count. `OccHost` becomes the
port's `CharTable` (blockbits.py) without the f32 planes, which served the
TPU matrix unit's one-hot lookup.

`occ_step` is the plain PyTorch step; K9 and K10 in `csrc/occblock.cu`
compute the same function per thread.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .blockbits import MAX_SIGMA, CharTable

DEFAULT_P = 128
NCP = 16        # checkpoint words per row (rank 15 is the padding's)


def _nwords(P: int) -> int:
    """int32 words of the 4-bit prevchar + P block characters."""
    return -(-(P + 1) // 8)


class OccMeta(NamedTuple):
    """Static scalars of an occ-block index (kernel launch arguments)."""
    n: int
    P: int
    sigma: int
    has_samples: bool
    has_doc: bool
    last_run_sample: int = 0
    last_run_edoc: int = 0
    first_run_sdoc: int = 0

    @property
    def nb(self) -> int:
        # a forced jump-up from the last occurrence of the largest char
        # probes F-space index n (occblock.py:112-116)
        return -(-(self.n + 1) // self.P)

    @property
    def nwords(self) -> int:
        return _nwords(self.P)

    @property
    def T0(self) -> int:
        return NCP + self.nwords

    @property
    def S0(self) -> int:
        """samples_start column, -1 without SA samples (esamp at S0 + P)."""
        return self.T0 + self.P if self.has_samples else -1

    @property
    def D0(self) -> int:
        """sdoc column, -1 without doc ids (edoc at D0 + P)."""
        if not self.has_doc:
            return -1
        return self.T0 + self.P + (2 * self.P if self.has_samples else 0)

    @property
    def width(self) -> int:
        return self.T0 + self.P * (1 + 2 * self.has_samples
                                   + 2 * self.has_doc)


def eligible(idx) -> bool:
    """True when the occ-block layout holds the index: sigma <= 15 and
    n < 2^31 (see the module docstring for the dropped TPU bound)."""
    sigma = int(np.count_nonzero(np.asarray(idx.cnt)))
    return sigma <= MAX_SIGMA and int(idx.n) < 2**31


class OccIndex(nn.Module):
    """The occ-block rows as module buffers: `blocks` [nb, W] int32, the
    optional `text` uint8 (unpadded; MS extension), and the 0-d int32
    scalars n, last_run_sample, last_run_edoc and first_run_sdoc, so one
    `.to(device)` moves them all; `meta` keeps the scalars as Python
    ints."""

    def __init__(self, blocks: torch.Tensor, meta: OccMeta,
                 text: Optional[torch.Tensor] = None):
        super().__init__()
        if meta.P < 1 or meta.P & (meta.P - 1):
            raise ValueError(f"P must be a power of two, not {meta.P}")
        shape = (meta.nb, meta.width)
        if blocks.dtype != torch.int32 or tuple(blocks.shape) != shape:
            raise ValueError(f"blocks must be int32 of shape {shape}, not "
                             f"{blocks.dtype} {tuple(blocks.shape)}")
        if text is not None and (text.dtype != torch.uint8
                                 or text.dim() != 1):
            raise ValueError("text must be a 1-D uint8 tensor")
        self.meta = meta
        self.register_buffer("blocks", blocks)
        self.register_buffer("text", text)
        for name in ("n", "last_run_sample", "last_run_edoc",
                     "first_run_sdoc"):
            self.register_buffer(name, torch.tensor(getattr(meta, name),
                                                    dtype=torch.int32))

    @property
    def text_bound(self) -> int:
        """The text length rounded up to a power of two: the JAX package
        zero-pads its device text to it (occblock.py:167-173) and the MS
        extension compares reads against the padding."""
        return max(1, 1 << (int(self.text.shape[0]) - 1).bit_length())

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.meta._asdict().items())


def build_occblock(idx, want_samples: Optional[bool] = None,
                   want_doc: Optional[bool] = None,
                   want_text: Optional[bool] = None, P: int = DEFAULT_P):
    """DenseIndex -> (OccIndex on the CPU, CharTable). The rows equal the
    JAX package's `blocks` for the same flags and P (occblock.py:85-191);
    they are written in int32 one column block at a time, where the JAX
    build casts a whole int64 [nb, W] matrix. The flags default to what
    the index has."""
    if want_samples is None:
        want_samples = idx.c_ssamp is not None
    if want_doc is None:
        want_doc = idx.c_sdoc is not None
    if want_text is None:
        want_text = idx.text is not None
    if want_samples and idx.c_ssamp is None:
        raise ValueError("MS rows need an index with SA samples (build -M)")
    if want_doc and idx.c_sdoc is None:
        raise ValueError("doc rows need an index with doc ids (build -d)")
    n = int(idx.n)
    cnt = np.asarray(idx.cnt, dtype=np.int64)
    F = np.asarray(idx.F, dtype=np.int64)
    index_chars = np.nonzero(cnt)[0]
    sigma = len(index_chars)
    if sigma > MAX_SIGMA or n >= 2**31:
        raise ValueError("the occ-block layout needs sigma <= 15 and "
                         "n < 2^31 (use the layered engine)")
    meta = OccMeta(n=n, P=P, sigma=sigma, has_samples=bool(want_samples),
                   has_doc=bool(want_doc),
                   last_run_sample=int(idx.last_run_sample),
                   last_run_edoc=int(idx.last_run_edoc),
                   first_run_sdoc=int(idx.first_run_sdoc))
    if P < 1 or P & (P - 1):
        raise ValueError(f"P must be a power of two, not {P}")
    nb = meta.nb
    rows = np.zeros((nb, meta.width), dtype=np.int32)

    rmap = np.full(256, MAX_SIGMA, dtype=np.uint8)
    rmap[index_chars] = np.arange(sigma, dtype=np.uint8)
    run_starts = np.asarray(idx.run_starts, dtype=np.int64)
    bwt = np.full(nb * P, MAX_SIGMA, dtype=np.uint8)   # build ranks, padded
    bwt[:n] = rmap[np.repeat(np.asarray(idx.run_heads, dtype=np.uint8),
                             np.diff(np.append(run_starts, n)))]
    blocks2d = bwt.reshape(nb, P)

    # occ checkpoints in F-space; ranks past sigma stay 0
    for rk, ch in enumerate(index_chars):
        occ = np.zeros(nb, dtype=np.int64)
        np.cumsum(np.count_nonzero(blocks2d[:-1] == rk, axis=1),
                  out=occ[1:])
        rows[:, rk] = occ + F[ch]

    # prevchar + chars, 4-bit packed (nibble 0 = prevchar)
    nib = np.full((nb, meta.nwords * 8), MAX_SIGMA, dtype=np.uint8)
    nib[1:, 0] = blocks2d[:-1, -1]
    nib[:, 1:P + 1] = blocks2d
    words = np.zeros((nb, meta.nwords), dtype=np.uint32)
    for j in range(8):
        words |= nib[:, j::8].astype(np.uint32) << np.uint32(4 * j)
    rows[:, NCP:meta.T0] = words.view(np.int32)
    del bwt, blocks2d, nib, words

    # per-occurrence tables in F-space: the char-grouped run arrays are in
    # (char ascending, BWT order) = F-space order, so one np.repeat lays
    # each out; samples_last and edoc are shifted by one (the jump-up reads
    # the run of occurrence rank - 1 at the candidate's own offset)
    c_len = np.asarray(idx.c_len, dtype=np.int64)

    def put(col, per_run, shift=0):
        flat = np.zeros(nb * P, dtype=np.int32)
        flat[shift:shift + n] = np.repeat(np.asarray(per_run, np.int32),
                                          c_len)
        rows[:, col:col + P] = flat.reshape(nb, P)

    put(meta.T0, idx.c_thr)
    if want_samples:
        put(meta.S0, idx.c_ssamp)
        put(meta.S0 + P, idx.c_esamp, shift=1)
    if want_doc:
        put(meta.D0, idx.c_sdoc)
        put(meta.D0 + P, idx.c_edoc, shift=1)

    text = None
    if want_text and idx.text is not None:
        text = torch.from_numpy(np.array(idx.text, dtype=np.uint8))
    table = CharTable(F, cnt, rmap, F[index_chars],
                      F[index_chars] + cnt[index_chars], index_chars)
    return OccIndex(torch.from_numpy(rows), meta, text), table


def from_jax(arrays_np: dict, meta_fields: dict) -> OccIndex:
    """OccIndex from the JAX package's state, passed as numpy: `arrays_np`
    = the OccArrays fields, `meta_fields` = OccMeta._asdict(). The
    power-of-two padding of `text` (past n - 1 bytes) is cut off. The
    CharTable comes from the same dense index (build_occblock) or the JAX
    OccHost's fields (CharTable(h.F_all, h.cnt_all, h.rmap, h.F_sigma,
    h.Fnext_sigma, h.index_chars))."""
    n = int(np.asarray(arrays_np["n"]))
    meta = OccMeta(
        n=n, P=int(meta_fields["P"]), sigma=int(meta_fields["sigma"]),
        has_samples=bool(meta_fields["has_samples"]),
        has_doc=bool(meta_fields["has_doc"]),
        last_run_sample=int(np.asarray(arrays_np["last_run_sample"])),
        last_run_edoc=int(np.asarray(arrays_np["last_run_edoc"])),
        first_run_sdoc=int(np.asarray(arrays_np["first_run_sdoc"])))
    if int(meta_fields["width"]) != meta.width:
        raise ValueError(f"row width {meta_fields['width']} != the layout's "
                         f"{meta.width}")
    text = arrays_np.get("text")
    if text is not None:
        text = torch.from_numpy(np.array(np.asarray(text)[:n - 1]))
    blocks = torch.from_numpy(np.require(np.asarray(arrays_np["blocks"]),
                                         np.int32, ["C", "W"]))
    return OccIndex(blocks, meta, text)


# ---------------------------------------------------------------------------
# small seeded inputs for the kernel checks (tests/test_torch_occ_kernels
# and chip_smoke.py phase 3d; rows staged by blockbits.ranked_rows)
# ---------------------------------------------------------------------------

def seeded_occ(seed: int, n: int, alphabet=b"ACGT", docs: bool = False,
               P: int = DEFAULT_P, samples: bool = True,
               doc_rows: Optional[bool] = None) -> tuple:
    """(text, OccIndex with the text, CharTable, NativeQueryEngine over the
    same tables) for n seeded bytes of `alphabet` (bytes or uint8 array);
    the text is split into two documents with docs=True. The rows hold SA
    samples unless samples=False, and doc ids when doc_rows (default: docs),
    so one seed gives each row layout a run can ask for."""
    from .. import _host

    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(bytes(alphabet), np.uint8), n)
    raw = _host.build_raw_index(text)
    fmt = _host.index_format
    ds = de = None
    if docs:
        ds, de = fmt.build_doc_arrays(raw, [len(text) // 2,
                                            len(text) - len(text) // 2])
    dense = fmt.build_dense_index(raw, text=text, with_samples=True,
                                  doc_start=ds, doc_end=de)
    native = _host.NativeQueryEngine(
        raw.n, raw.run_heads, raw.run_starts, raw.thresholds,
        raw.samples_start, raw.samples_last, start_doc=ds, end_doc=de,
        text=text)
    index, table = build_occblock(dense, want_samples=samples,
                                  want_doc=doc_rows, want_text=True, P=P)
    return text, index, table, native


# ---------------------------------------------------------------------------
# the plain PyTorch step
# ---------------------------------------------------------------------------

def occ_initial_state(index: OccIndex, B: int, device) -> tuple:
    """The carry (cand, prev_p, pending, forced, length, sample_prev,
    was_match, was_empty, doc_prev) of occblock.py:248-259: cand = n - 1
    resolves to n - 1, and was_match makes the first resolved sample
    last_run_sample. Integers are [B] int64, flags [B] bool."""
    m = index.meta
    full = lambda v: torch.full((B,), v, dtype=torch.int64,  # noqa: E731
                                device=device)
    flag = lambda v: torch.full((B,), v, dtype=torch.bool,   # noqa: E731
                                device=device)
    return (full(m.n - 1), full(0), flag(False), flag(False), full(0),
            full(m.last_run_sample + 1), flag(True), flag(False),
            full(m.last_run_edoc))


def occ_step(index: OccIndex, tab: torch.Tensor, carry: tuple,
             qc: torch.Tensor, mode: str, use_doc: bool) -> tuple:
    """One pipelined backward step over a [B] batch of query-rank codes:
    the port of make_occ_step_fn (occblock.py:262-354). Returns (new
    carry, (val, doc)): val the PML length of this step's character, or in
    MS mode the sample of the PREVIOUS step's; doc the previous step's doc
    id (both resolved from the row this step reads)."""
    m = index.meta
    P, W = m.P, m.width
    (cand, prev_p, pending, forced, length, sample_prev, was_match,
     was_empty, doc_prev) = carry
    t = tab[qc.long()]                                        # [B, 5]
    c_blk, empty, Fb, Fnext = t[:, 0], t[:, 1] == 1, t[:, 2], t[:, 3]

    # THE row: the block of the unresolved candidate
    flat = index.blocks.view(-1)
    base = (cand >> (P.bit_length() - 1)).clamp(0, m.nb - 1) * W
    off = cand & (P - 1)

    def at(col):
        return flat[base + col].long()

    # resolve the previous step's jump direction from thr[cand % P]
    minus1 = forced | (pending & (prev_p < at(m.T0 + off)))
    p = cand - minus1.long()
    pos_off = off - minus1.long()                             # in [-1, P-1]

    ms = mode == "ms"
    if ms:   # the previous step's sample
        s = torch.where(was_match, sample_prev - 1, torch.where(
            was_empty, 0, torch.where(minus1, at(m.S0 + P + off),
                                      at(m.S0 + off))))
    else:
        s = sample_prev
    if use_doc:
        jumped = torch.where(minus1, at(m.D0 + P + off), at(m.D0 + off))
        if ms:   # an absent char resets the doc (compute_ms_pml.cpp:639)
            d = torch.where(was_empty, m.first_run_sdoc,
                            torch.where(was_match, doc_prev, jumped))
        else:    # ... and keeps it in PML mode (:303)
            d = torch.where(was_empty | was_match, doc_prev, jumped)
    else:
        d = doc_prev

    # this step's char from the resolved position p: nibble g of the row's
    # char words, g = 0 the prevchar, g = j + 1 block offset j
    cols = NCP + torch.arange(m.nwords, device=cand.device)
    words = flat[base[:, None] + cols].long() & 0xFFFFFFFF    # [B, nw]
    shifts = 4 * torch.arange(8, device=cand.device)
    nibs = ((words[:, :, None] >> shifts) & 15).reshape(len(cand), -1)
    g = torch.arange(nibs.shape[1], device=cand.device)[None, :]
    is_c = nibs == c_blk[:, None]
    inblock = ((g >= 1) & (g <= pos_off[:, None]) & is_c).sum(dim=1)
    inblock = inblock - ((pos_off < 0) & is_c[:, 0]).long()
    bwt_p = nibs.gather(1, (pos_off + 1)[:, None])[:, 0]

    A = at(c_blk) + inblock                                   # F[c] + rank
    is_match = ~empty & (bwt_p == c_blk)
    has_next = A < Fnext
    new_pending = ~empty & ~is_match & has_next
    new_forced = ~empty & ~is_match & ~has_next
    new_length = torch.where(is_match, length + 1, 0)
    new_cand = torch.where(empty, Fb, A)
    return ((new_cand, p, new_pending, new_forced, new_length, s, is_match,
             empty, d), (s if ms else new_length, d))
