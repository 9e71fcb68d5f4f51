"""Layered index (engine v2 layout) for the PyTorch port.

Host side of `spumoni_tpu/engine/layered.py`: the engine for indexes the
block-bits layout cannot hold, i.e. more than 8 BWT characters (`-m`
promoted-minimizer digestion, `-g` general text), `--engine layered`, and
MS / doc tracking with r >= 2^30. Per character c, level t holds every
64^t-th run start of c, padded with the sentinel n to whole 64-entry rows;
a step descends D = ceil(log_64(max runs per char)) levels to the run k of
c whose start is the last one <= pos, then reads one `fields` row:

    row k+1 = [start_k, len_k, cum_k, thr_{k+1}
               (, esamp_k, ssamp_{k+1}, edoc_k, sdoc_{k+1})]

the current run's match / rank data and the next run's jump-down targets.
`charmeta` [256, 16] holds F, cnt, lo0 = char_off[c], hi0 = char_off[c+1]
and the level row offsets of every byte, so reads are staged as raw bytes.

The JAX package's TPU workarounds are not carried over: the one-hot f32
`rootmat_planes` (bf16 matrix-unit exactness; the kernels read `charmeta`
and the root row directly), the FIELD_GROUP grouping at the 2^17-row gather
cliff (group = 1 here), the power-of-two padding of `fields` and `text`,
and the chunked uploads. A position past the BWT (n, after a byte that
sorts after every index character) makes the descent count the sentinels;
level rows clamp to the level's last row, and the field probe stops at
c's last run, as SPUMONI's query loop (`NativeQueryEngine`) does, where
the JAX step reads padded field rows. The text's bound is kept as
`text_bound`.

`layered_step` is the plain PyTorch step; K7 and K8 in `csrc/layered.cu`
compute the same function per thread.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import trace

NODE = 64
MAX_DEPTH = 12   # 4 + D charmeta columns
# field slots: START / LEN / CUM / ESAMP / EDOC describe run k (row k+1),
# THR / SSAMP / SDOC the next run k+1 (the jump-down target)
F_START, F_LEN, F_CUM, F_THR, F_ESAMP, F_SSAMP, F_EDOC, F_SDOC = range(8)


class LayeredMeta(NamedTuple):
    """Static scalars of a layered index (kernel launch arguments)."""
    n: int
    r: int
    depth: int              # D
    width: int              # W: 4 (PML only) or 8 (samples / doc)
    wide: bool              # int64 positions
    has_samples: bool
    has_doc: bool
    last_run_sample: int = 0
    last_run_edoc: int = 0
    first_run_sdoc: int = 0

    @property
    def pos_dtype(self) -> torch.dtype:
        return torch.int64 if self.wide else torch.int32


class LayeredIndex(nn.Module):
    """The layered tables as module buffers: `charmeta` [256, 16], the D
    levels `level0` .. (`levels` lists them) [rows_t, 64], `fields`
    [r+1, W], the optional `text` uint8 (MS extension), and the 0-d scalars
    n, last_run_sample, last_run_edoc, first_run_sdoc; all in
    meta.pos_dtype except the text. One `.to(device)` moves them all;
    `meta` keeps the scalars as Python ints."""

    def __init__(self, charmeta: torch.Tensor, levels, fields: torch.Tensor,
                 meta: LayeredMeta, text: Optional[torch.Tensor] = None):
        super().__init__()
        dt = meta.pos_dtype
        if not 1 <= meta.depth <= MAX_DEPTH or len(levels) != meta.depth:
            raise ValueError(f"depth {meta.depth} with {len(levels)} levels "
                             f"(1 <= D <= {MAX_DEPTH})")
        for name, t, shape in (("charmeta", charmeta, (256, 16)),
                               ("fields", fields, (meta.r + 1, meta.width))):
            if t.dtype != dt or tuple(t.shape) != shape:
                raise ValueError(f"{name} must be {dt} of shape {shape}, not "
                                 f"{t.dtype} {tuple(t.shape)}")
        for t, lv in enumerate(levels):
            if lv.dtype != dt or lv.dim() != 2 or lv.shape[1] != NODE:
                raise ValueError(f"level {t} must be a [rows, {NODE}] {dt} "
                                 f"tensor")
        if text is not None and (text.dtype != torch.uint8
                                 or text.dim() != 1):
            raise ValueError("text must be a 1-D uint8 tensor")
        self.meta = meta
        self.register_buffer("charmeta", charmeta)
        for t, lv in enumerate(levels):
            self.register_buffer(f"level{t}", lv)
        self.register_buffer("fields", fields)
        self.register_buffer("text", text)
        for name in ("n", "last_run_sample", "last_run_edoc",
                     "first_run_sdoc"):
            self.register_buffer(name, torch.tensor(getattr(meta, name),
                                                    dtype=dt))

    @property
    def levels(self) -> list:
        return [getattr(self, f"level{t}") for t in range(self.meta.depth)]

    @property
    def text_bound(self) -> int:
        """The text length rounded up to a power of two: the JAX package
        zero-pads its device text to it (layered.py:184-189) and the MS
        extension compares reads against the padding."""
        return max(1, 1 << (int(self.text.shape[0]) - 1).bit_length())

    def extra_repr(self) -> str:
        return ", ".join(f"{k}={v}" for k, v in self.meta._asdict().items())


def depth_for(char_off) -> int:
    """D = ceil(log_64(max runs per char)), at least 1 (layered.py:102-104)."""
    max_rc = int(np.diff(np.asarray(char_off, dtype=np.int64)).max())
    return max(1, math.ceil(math.log(max(max_rc, 2), NODE)))


def build_layered(idx, dtype=None) -> LayeredIndex:
    """DenseIndex -> LayeredIndex on the CPU, with the array contents of
    spumoni_tpu/engine/layered.py::build_layered (its padding cut off).
    SA samples, doc ids and text are included when the index has them.
    dtype overrides the position type (int32 while n < 2^31 - 2, else
    int64). Spans (trace.py) `load.fields` (levels, char table, fields)
    and `load.text`."""
    with trace.span("load.fields"):
        charmeta, levels, fields, meta = _layered_tables(idx, dtype)
    text = None
    with trace.span("load.text"):
        if idx.text is not None:
            text = torch.from_numpy(np.array(idx.text, dtype=np.uint8))
    return LayeredIndex(charmeta, levels, fields, meta, text)


def _layered_tables(idx, dtype) -> tuple:
    """(charmeta, levels, fields, meta) of build_layered, as tensors."""
    want_samples = idx.c_ssamp is not None
    want_doc = idx.c_sdoc is not None
    n, r = int(idx.n), int(idx.r)
    if dtype is None:
        dtype = np.int32 if n < 2**31 - 2 else np.int64
    dtype = np.dtype(dtype)
    char_off = np.asarray(idx.char_off, dtype=np.int64)
    D = depth_for(char_off)
    if D > MAX_DEPTH:
        raise ValueError("depth too large for the charmeta row")
    c_start = np.asarray(idx.c_start, dtype=np.int64)

    levels = []
    rowoffs = np.zeros((D, 256), dtype=np.int64)
    for t in range(D):
        step = NODE ** t
        rows_all, off = [], 0
        for c in range(256):
            entries = c_start[char_off[c]:char_off[c + 1]:step]
            nrows = max(1, -(-len(entries) // NODE))
            row = np.full(nrows * NODE, n, dtype=np.int64)
            row[:len(entries)] = entries
            rowoffs[t, c] = off
            rows_all.append(row.reshape(nrows, NODE))
            off += nrows
        levels.append(np.concatenate(rows_all).astype(dtype))

    charmeta = np.zeros((256, 16), dtype=np.int64)
    charmeta[:, 0] = np.asarray(idx.F)
    charmeta[:, 1] = np.asarray(idx.cnt)
    charmeta[:, 2] = char_off[:256]
    charmeta[:, 3] = char_off[1:257]
    charmeta[:, 4:4 + D] = rowoffs.T

    W = 8 if (want_samples or want_doc) else 4
    fields = np.zeros((r + 1, W), dtype=dtype)
    fields[:, F_START] = n       # row 0: the virtual predecessor of run 0
    fields[1:, F_START] = c_start
    fields[1:, F_LEN] = np.asarray(idx.c_len)
    fields[1:, F_CUM] = np.asarray(idx.c_cum)
    fields[:r, F_THR] = np.asarray(idx.c_thr)
    if want_samples:
        fields[1:, F_ESAMP] = np.asarray(idx.c_esamp)
        fields[:r, F_SSAMP] = np.asarray(idx.c_ssamp)
    if want_doc:
        fields[1:, F_EDOC] = np.asarray(idx.c_edoc)
        fields[:r, F_SDOC] = np.asarray(idx.c_sdoc)

    meta = LayeredMeta(
        n=n, r=r, depth=D, width=W, wide=dtype == np.int64,
        has_samples=want_samples, has_doc=want_doc,
        last_run_sample=int(idx.last_run_sample),
        last_run_edoc=int(idx.last_run_edoc),
        first_run_sdoc=int(idx.first_run_sdoc))
    return (torch.from_numpy(charmeta.astype(dtype)),
            [torch.from_numpy(lv) for lv in levels],
            torch.from_numpy(fields), meta)


def from_jax(arrays_np: dict, meta_fields: dict) -> LayeredIndex:
    """LayeredIndex from the JAX package's state, passed as numpy:
    `arrays_np` = the LayeredArrays fields (`levels` a sequence, the
    `rootmat_planes` ignored), `meta_fields` = LayeredMeta._asdict(). Grouped
    fields (group > 1) are un-grouped; the padding of `fields` (past row r)
    and of `text` (past n - 1 bytes) is cut off."""
    if meta_fields.get("tp_axis") is not None:
        raise ValueError("a sharded (TP) layered state does not carry over")
    if int(meta_fields["node"]) != NODE:
        raise ValueError(f"the port's layered engine has node width {NODE}, "
                         f"not {meta_fields['node']}")
    charmeta = np.asarray(arrays_np["charmeta"])
    W = int(meta_fields["width"])
    r = int(charmeta[:, 3].max())           # char_off[256]
    n = int(np.asarray(arrays_np["n"]))
    fields = np.asarray(arrays_np["fields"]).reshape(-1, W)
    text = arrays_np.get("text")
    if text is not None:
        text = torch.from_numpy(np.array(np.asarray(text)[:n - 1]))
    meta = LayeredMeta(
        n=n, r=r, depth=int(meta_fields["depth"]), width=W,
        wide=np.dtype(meta_fields["dtype"]) == np.int64,
        has_samples=bool(meta_fields["has_samples"]),
        has_doc=bool(meta_fields["has_doc"]),
        last_run_sample=int(np.asarray(arrays_np["last_run_sample"])),
        last_run_edoc=int(np.asarray(arrays_np["last_run_edoc"])),
        first_run_sdoc=int(np.asarray(arrays_np["first_run_sdoc"])))
    return LayeredIndex(
        torch.from_numpy(np.array(charmeta)),
        [torch.from_numpy(np.array(lv)) for lv in arrays_np["levels"]],
        torch.from_numpy(np.array(fields[:r + 1])), meta, text)


# ---------------------------------------------------------------------------
# small seeded inputs for the kernel checks (tests/test_torch_layered_kernels
# and chip_smoke.py phase 3c)
# ---------------------------------------------------------------------------

def seeded_layered(seed: int, n: int, alphabet=b"ACGT", docs: bool = False,
                   digest: bool = False, dtype=None) -> tuple:
    """(text, LayeredIndex with SA samples and text, NativeQueryEngine over
    the same tables) for n seeded bytes of `alphabet` (bytes or uint8
    array); the text is -m digested with digest=True and split into two
    documents with docs=True."""
    from ..index import format as fmt
    from ..io.minimizers import digest_promotion
    from ..native import NativeQueryEngine, build_raw_index

    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(bytes(alphabet), np.uint8), n)
    if digest:
        text = np.frombuffer(digest_promotion(text.tobytes()), np.uint8)
    raw = build_raw_index(text)
    ds = de = None
    if docs:
        ds, de = fmt.build_doc_arrays(raw, [len(text) // 2,
                                            len(text) - len(text) // 2])
    dense = fmt.build_dense_index(raw, text=text, with_samples=True,
                                  doc_start=ds, doc_end=de)
    native = NativeQueryEngine(
        raw.n, raw.run_heads, raw.run_starts, raw.thresholds,
        raw.samples_start, raw.samples_last, start_doc=ds, end_doc=de,
        text=text)
    return text, build_layered(dense, dtype=dtype), native


def raw_rows(reads, L: int, device="cpu") -> tuple:
    """([B, L] reversed raw rows, [B, L] forward raw rows, [B] int64 lens)
    on `device`, as the layered engine stages them."""
    rev = np.zeros((len(reads), L), np.uint8)
    fwd = np.zeros((len(reads), L), np.uint8)
    for i, rd in enumerate(reads):
        a = np.frombuffer(rd, np.uint8)
        rev[i, :len(a)] = a[::-1]
        fwd[i, :len(a)] = a
    lens = np.asarray([len(r) for r in reads], np.int64)
    return tuple(torch.from_numpy(x).to(device) for x in (rev, fwd, lens))


# ---------------------------------------------------------------------------
# the plain PyTorch step
# ---------------------------------------------------------------------------

def initial_state(index: LayeredIndex, B: int, device) -> tuple:
    """The recurrence seed (pos, length, sample, doc) = (n - 1, 0,
    last_run_sample, last_run_edoc) as [B] int64 tensors
    (scan_engine.py:107-116)."""
    m = index.meta
    full = lambda v: torch.full((B,), v, dtype=torch.int64,  # noqa: E731
                                device=device)
    return (full(m.n - 1), full(0), full(m.last_run_sample),
            full(m.last_run_edoc))


def layered_step(index: LayeredIndex, carry: tuple, chars: torch.Tensor,
                 mode: str, use_doc: bool) -> tuple:
    """One backward step over a [B] batch of raw bytes: the port of
    make_layered_step_fn (layered.py:270-390) in int64. Returns the new
    carry (pos, length, sample, doc); the emitted value is the new sample
    in MS mode, the new length in PML mode, and the doc the new doc."""
    m = index.meta
    pos, length, sample, doc = carry
    cm = index.charmeta[chars.long()].long()                  # [B, 16]
    Fc, cntc, lo0, hi0 = cm[:, 0], cm[:, 1], cm[:, 2], cm[:, 3]

    # 64-ary descent: rank = index within c of the last run start <= pos;
    # m == 0 is possible only at the top level (pos before the first c-run)
    rank = torch.zeros_like(pos)
    dead = torch.zeros_like(pos, dtype=torch.bool)
    for t, level in reversed(list(enumerate(index.levels))):
        at = (cm[:, 4 + t] + rank).clamp(max=level.shape[0] - 1)
        rows = level[at].long()                               # [B, 64]
        cnt_le = (rows <= pos[:, None]).sum(dim=1)
        if t == m.depth - 1:
            dead = cnt_le == 0
        rank = rank * NODE + (cnt_le - 1).clamp(min=0)
    valid = ~dead
    # row k+1 holds run k and the next run's targets; the probe stops at row
    # hi0, c's last run: past the BWT (pos = n, after a byte that sorts
    # after every index character) every entry counts, padding too, and the
    # run is c's last, as SPUMONI's upper bound over c's run starts finds
    # it. A dead lane probes row lo0, whose threshold (run lo0's) is 0: the
    # jump down the reference takes when rank(pos, c) == 0
    # (compute_ms_pml.cpp:259-268)
    probe = torch.minimum(torch.where(valid, lo0 + rank + 1, lo0), hi0)
    row = index.fields[probe].long()                          # [B, W]
    start, rlen, cum = row[:, F_START], row[:, F_LEN], row[:, F_CUM]
    is_match = valid & (pos < start + rlen)
    rnk = torch.where(valid, cum + torch.minimum(pos - start, rlen), 0)
    has_next = torch.where(valid, (rank + 1) < (hi0 - lo0), cntc > 0)
    jump_down = ~is_match & has_next & (pos >= row[:, F_THR])
    empty = cntc == 0

    new_length = torch.where(is_match, length + 1, 0)
    new_pos = torch.where(empty, Fc, torch.where(is_match | jump_down,
                                                 Fc + rnk, Fc + rnk - 1))
    ms = mode == "ms"
    if ms:
        new_sample = torch.where(
            empty, 0, torch.where(is_match, sample - 1, torch.where(
                jump_down, row[:, F_SSAMP], row[:, F_ESAMP])))
    else:
        new_sample = sample
    if use_doc:
        jumped = torch.where(jump_down, row[:, F_SDOC], row[:, F_EDOC])
        if ms:   # an absent char resets the doc (compute_ms_pml.cpp:639)
            new_doc = torch.where(empty, m.first_run_sdoc,
                                  torch.where(is_match, doc, jumped))
        else:    # ... and keeps it in PML mode (:303)
            new_doc = torch.where(empty | is_match, doc, jumped)
    else:
        new_doc = doc
    return new_pos, new_length, new_sample, new_doc
