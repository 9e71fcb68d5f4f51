"""The sharded index of the port (`run --tp-devices S`).

Counterpart of `spumoni_tpu/parallel/tp.py`. The JAX package shards the
largest tables of an index by rows over the `model` axis of a device mesh
and rebuilds every row a scan step reads with an owner-masked local gather
and a psum. The port cuts the same tables by rows into S shards, each a
tensor of its own, and kernels K13-K16 (`engine/kernels.py`) read row r
straight from shard r // rows_per_shard. On one device all S shards sit on
it; `place_shards` puts shard i on the i-th of several cards, whose
kernels then read each other's shards as peers.

  * `shard_blockbits`: block-bits `bblocks`, zero-padded to a multiple of
    S rows (tp.py:92-109), for report-only PML (K13).
  * `shard_blockbits_ms`: `bblocks` and `msrows` zero-padded to the same
    rows, the jump tables `jump_t` / `jump_d` zero-padded, and the text in
    whole 512-byte rows (tp.py:213-239, 282-292), for -M runs (K15, K16).
  * `shard_layered`: layered `fields`, its r + 1 rows zero-padded to a
    multiple of S (JAX pads its power-of-two table with sentinel rows,
    tp.py:65-89, which its probes reach past the BWT; the port's stop at
    row r), for report-only PML (K14).
  * `place_shards`: a copy with shard i of every table on devices[i %
    len(devices)] and the unsharded tables on devices[0].
  * `from_jax`: the same sharded index from the state of a JAX
    `TpPmlClassifier` or `TpMsQuery`.

A shard table's rows are read by index (`ShardedTable.__getitem__`, the
owner-masked read in plain PyTorch), so the plain versions of K2, K3, K4
and K8 run unchanged over a sharded index and are the plain versions of
K13-K16.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..engine import blockbits as bb
from ..engine import layered as lay

#: shards a kernel takes (kMaxShards of csrc/sharded.cuh)
MAX_SHARDS = 16
#: bytes of one row of the JAX package's sharded text table
TEXT_ROW = 512
#: K16's limit on its shards' bytes (csrc/blockbits_ms.cu, spn_ms_extend_tp:
#: 16-byte words counted in 32 bits)
MAX_SHARDED_TEXT = 1 << 36


class ShardedTable(nn.Module):
    """A table cut by rows into S tensors of rows_per_shard rows each, the
    last padded: row r lies in shard r // rows_per_shard. Reading rows by
    index (`table[idx]`) takes each from its owner shard and gives 0 for an
    index outside the padded rows, as the JAX owner-masked read and psum do
    (tp.py:242-252)."""

    def __init__(self, shards):
        super().__init__()
        shards = list(shards)
        if not 1 <= len(shards) <= MAX_SHARDS:
            raise ValueError(f"{len(shards)} shards: a sharded table takes 1 "
                             f"to {MAX_SHARDS}")
        first = shards[0]
        for t in shards:
            if t.shape != first.shape or t.dtype != first.dtype \
                    or t.dim() < 1 or t.shape[0] < 1:
                raise ValueError("shards must be non-empty tensors of one "
                                 "shape and dtype")
        self.S = len(shards)
        for i, t in enumerate(shards):
            self.register_buffer(f"shard{i}", t)

    @classmethod
    def from_rows(cls, table: torch.Tensor, S: int,
                  rows_per_shard: Optional[int] = None) -> "ShardedTable":
        """S shards of `table`'s rows (ceil(rows / S) each unless given),
        each a copy, so the full table can be freed; rows past the table are
        zero."""
        if not 1 <= S <= MAX_SHARDS:
            raise ValueError(f"S={S}: a sharded table takes 1 to "
                             f"{MAX_SHARDS} shards")
        rows = table.shape[0]
        rps = rows_per_shard or max(1, -(-rows // S))
        if rps * S < rows:
            raise ValueError(f"{S} shards of {rps} rows hold fewer than "
                             f"{rows}")
        shards = []
        for i in range(S):
            piece = table[i * rps:(i + 1) * rps]
            if piece.shape[0] < rps:
                fill = torch.zeros((rps - piece.shape[0],) + table.shape[1:],
                                   dtype=table.dtype, device=table.device)
                piece = torch.cat([piece, fill])
            shards.append(piece.contiguous().clone())
        return cls(shards)

    @property
    def shards(self) -> list:
        return [getattr(self, f"shard{i}") for i in range(self.S)]

    @property
    def rows_per_shard(self) -> int:
        return self.shard0.shape[0]

    @property
    def shape(self) -> torch.Size:
        """The padded table's shape: S * rows_per_shard rows."""
        return torch.Size((self.S * self.rows_per_shard,)
                          + tuple(self.shard0.shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.shard0.dtype

    @property
    def device(self) -> torch.device:
        return self.shard0.device

    def is_contiguous(self) -> bool:
        return all(t.is_contiguous() for t in self.shards)

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows `idx` (an integer tensor of any shape), each from its owner
        shard; 0 outside [0, S * rows_per_shard). Every shard takes its
        clipped local rows and keeps the ones it owns, as the JAX
        owner-masked take does, without a host sync."""
        idx = idx.long()
        rps = self.rows_per_shard
        out = torch.zeros(tuple(idx.shape) + tuple(self.shard0.shape[1:]),
                          dtype=self.dtype, device=idx.device)
        for s, t in enumerate(self.shards):
            loc = idx - s * rps
            mine = ((loc >= 0) & (loc < rps)).reshape(
                tuple(idx.shape) + (1,) * (t.dim() - 1))
            out = torch.where(mine, t[loc.clamp(0, rps - 1)], out)
        return out


class ShardedBlockBits(nn.Module):
    """A block-bits index with its row tables in shards: `bblocks` and, for
    MS / doc tracking, `msrows` (the same rows_per_shard), `jump_t`,
    `jump_d` and the text (bytes, whole 512-byte rows), each a
    ShardedTable, with the BitMeta of the unsharded index. Blocks clamp to
    the padded row count, whose pad rows are zero."""

    def __init__(self, meta: bb.BitMeta, bblocks: ShardedTable,
                 msrows: Optional[ShardedTable] = None,
                 jump_t: Optional[ShardedTable] = None,
                 jump_d: Optional[ShardedTable] = None,
                 text: Optional[ShardedTable] = None, text_len: int = 0):
        super().__init__()
        if msrows is not None and (msrows.S != bblocks.S or
                                   msrows.rows_per_shard
                                   != bblocks.rows_per_shard):
            raise ValueError("msrows must be sharded as bblocks are")
        if jump_d is not None and jump_t is not None and (
                jump_d.S, jump_d.rows_per_shard) != (jump_t.S,
                                                     jump_t.rows_per_shard):
            raise ValueError("jump_t and jump_d must be sharded alike")
        self.meta = meta
        self.bblocks = bblocks
        self.msrows = msrows
        self.jump_t = jump_t
        self.jump_d = jump_d
        self.text = text
        self.text_len = int(text_len)

    @property
    def S(self) -> int:
        return self.bblocks.S

    @property
    def text_bound(self) -> int:
        """The unsharded index's text bound (BlockBitsIndex.text_bound)."""
        return max(1, 1 << (self.text_len - 1).bit_length())


class ShardedLayered(nn.Module):
    """A layered index with `fields` in shards (a ShardedTable) and
    `charmeta` and the levels whole."""

    def __init__(self, charmeta: torch.Tensor, levels,
                 fields: ShardedTable, meta: lay.LayeredMeta):
        super().__init__()
        if fields.shape[0] < meta.r + 1 or fields.shape[1] != meta.width:
            raise ValueError(f"fields of shape {tuple(fields.shape)} do not "
                             f"hold r+1={meta.r + 1} rows of width "
                             f"{meta.width}")
        self.meta = meta
        self.register_buffer("charmeta", charmeta)
        for t, lv in enumerate(levels):
            self.register_buffer(f"level{t}", lv)
        self.fields = fields
        self.text = None   # the sharded layered index serves PML only

    @property
    def levels(self) -> list:
        return [getattr(self, f"level{t}") for t in range(self.meta.depth)]

    @property
    def S(self) -> int:
        return self.fields.S


def shard_blockbits(index: bb.BlockBitsIndex, S: int) -> ShardedBlockBits:
    """K13's index: `bblocks` in S shards, zero-padded to a multiple of S
    rows (tp.py::shard_index_tp_bits)."""
    return ShardedBlockBits(index.meta,
                            ShardedTable.from_rows(index.bblocks, S))


def shard_blockbits_ms(index: bb.BlockBitsIndex, S: int) -> ShardedBlockBits:
    """K15 / K16's index: `bblocks` and `msrows` zero-padded to the same
    rows, `jump_t` and `jump_d` (when the index has them) zero-padded, in
    S shards each (tp.py::shard_index_tp_ms), and the text as JAX's rows512
    table holds it (tp.py:284-292): whole 512-byte rows, one more than the
    text fills, zero-padded to a multiple of S rows. The rows are counted
    from the text's own length, not its power-of-two bound: the extension
    reads 0 past the stored bytes up to text_bound, as past the text."""
    if index.msrows is None or index.jump_t is None or index.text is None:
        raise ValueError("a sharded MS index needs the msrows, the SA-sample "
                         "jump table and the text (build -M)")
    text_len = int(index.text.shape[0])
    return ShardedBlockBits(
        index.meta, ShardedTable.from_rows(index.bblocks, S),
        msrows=ShardedTable.from_rows(index.msrows, S),
        jump_t=ShardedTable.from_rows(index.jump_t, S),
        jump_d=None if index.jump_d is None
        else ShardedTable.from_rows(index.jump_d, S),
        text=shard_text(index.text, S), text_len=text_len)


def shard_text(text: torch.Tensor, S: int) -> ShardedTable:
    """The text in S shards as JAX's rows512 table holds it (tp.py:284-292):
    whole 512-byte rows, one more than the text fills, zero-padded to a
    multiple of S rows."""
    return ShardedTable.from_rows(text, S, rows_per_shard=sharded_text_bytes(
        int(text.shape[0]), S) // S)


def sharded_text_bytes(ntext: int, S: int) -> int:
    """The bytes shard_text's S shards hold for a text of ntext bytes."""
    rows512 = -(-ntext // TEXT_ROW) + 1
    return -(-rows512 // S) * TEXT_ROW * S


def shard_layered(index: lay.LayeredIndex, S: int) -> ShardedLayered:
    """K14's index: the r + 1 `fields` rows in S shards, zero-padded to a
    multiple of S rows (no probe passes row r)."""
    return ShardedLayered(index.charmeta, index.levels,
                          ShardedTable.from_rows(index.fields, S), index.meta)


def place_shards(index, devices):
    """A copy of the ShardedBlockBits or ShardedLayered `index` with shard i
    of each table on devices[i % len(devices)], and the unsharded tables
    (the layered charmeta and levels) on devices[0], where its kernels
    launch. They read the other devices' shards as peers, so the peer
    access between the CUDA devices of `devices` is opened first
    (kernels.enable_peer_access raises where a pair has none)."""
    from ..engine import kernels   # kernels imports this module

    devices = [torch.device(d) for d in devices]
    kernels.enable_peer_access(devices)

    def place(table):
        return None if table is None else ShardedTable(
            t.to(devices[i % len(devices)])
            for i, t in enumerate(table.shards))

    if isinstance(index, ShardedLayered):
        return ShardedLayered(index.charmeta.to(devices[0]),
                              [lv.to(devices[0]) for lv in index.levels],
                              place(index.fields), index.meta)
    return ShardedBlockBits(index.meta, place(index.bblocks),
                            place(index.msrows), place(index.jump_t),
                            place(index.jump_d), place(index.text),
                            index.text_len)


def from_jax(arrays_np: dict, meta_fields: dict, S: int,
             host_fields: Optional[dict] = None,
             t512: Optional[np.ndarray] = None):
    """The port's sharded index from a JAX TpPmlClassifier's or TpMsQuery's
    state, passed as numpy arrays assembled across the mesh: `arrays_np`
    the fields of its `arrays` (BitArrays or LayeredArrays), `meta_fields`
    its `meta._asdict()` (plus `n` for block-bits), `host_fields` (block-
    bits) `vars(host)`, `t512` (TpMsQuery) its rows512 text table. The JAX
    padding is cut off and the shards are cut by the port's rules, so they
    equal shard_blockbits(_ms) / shard_layered of the port's own build.
    Returns (ShardedBlockBits, CharTable) or a ShardedLayered."""
    meta_fields = {k: v for k, v in meta_fields.items() if k != "tp_axis"}
    if "bblocks" in arrays_np:
        n, P = int(meta_fields["n"]), int(meta_fields["P"])
        nb = -(-n // P)
        ms = None
        if meta_fields.get("has_ms"):
            text = None if t512 is None else np.ascontiguousarray(
                np.asarray(t512)).view(np.uint8).reshape(-1)
            ms = dict(msrows=np.asarray(arrays_np["msrows"])[:nb],
                      jump_t=arrays_np.get("jump_t"),
                      jump_d=arrays_np.get("jump_d"), text=text)
        index, table = bb.from_jax(np.asarray(arrays_np["bblocks"])[:nb],
                                   meta_fields, host_fields, ms)
        if ms is None:
            return shard_blockbits(index, S), table
        return shard_blockbits_ms(index, S), table
    W = int(meta_fields["width"])
    fields = np.asarray(arrays_np["fields"]).reshape(-1, W)
    index = lay.from_jax({**arrays_np, "fields": fields}, meta_fields)
    return shard_layered(index, S)
