"""The benchmark's data and traffic, made from the run's seed.

Pangenome (after `chip_smoke.make_inputs`): a uniform random base genome of
`strain_len` bases; strain 0 is the base, each other strain the base with
every position replaced by a uniform random base with probability
`divergence`.

Reads (a cell's traffic file): `reads` reads a call, half positives (even
indices, `pos_<i>`) and half negatives (odd, `neg_<i>`). Their lengths are
the same multiset for every seed: drawn once from the cell's `length_seed`
(fixed, or gamma with the given mean and sd, clipped), then shuffled by the
run's seed. A positive is copied from a uniform random strain, strand and
start, then read with `error_rate` errors a source base: substitutions (to
another base), deletions and insertions (a uniform random base before it),
in equal shares. A negative is uniform random ACGT.
"""

from __future__ import annotations

import os

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
_COMP[list(b"ACGT")] = list(b"TGCA")
_CODE = np.zeros(256, np.uint8)
_CODE[list(b"ACGT")] = [0, 1, 2, 3]
_BLOCK_CELLS = 1 << 24   # source bases mutated at once


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), stream])


def pangenome(config: dict, seed: int) -> list[np.ndarray]:
    r = rng(seed, 0)
    L = int(config["strain_len"])
    base = r.choice(ACGT, size=L)
    strains = [base]
    for _ in range(int(config["strains"]) - 1):
        s = base.copy()
        mut = r.random(L, dtype=np.float32) < float(config["divergence"])
        s[mut] = r.choice(ACGT, size=int(mut.sum()))
        strains.append(s)
    return strains


def write_pangenome(work: str, strains, build: str) -> dict:
    """The build's input files: one FASTA a strain and their list (one
    document each) for `docs`, one multi-record FASTA for `digest`."""
    if build == "docs":
        lst = os.path.join(work, "strains.txt")
        with open(lst, "w") as f:
            for i, s in enumerate(strains):
                path = os.path.join(work, f"strain_{i}.fa")
                with open(path, "wb") as g:
                    g.write(b">strain_%d\n" % i + s.tobytes() + b"\n")
                f.write(f"{path} {i + 1}\n")
        return {"list": lst}
    path = os.path.join(work, "pangenome.fa")
    with open(path, "wb") as f:
        for i, s in enumerate(strains):
            f.write(b">strain_%d\n" % i + s.tobytes() + b"\n")
    return {"fasta": path}


def read_lengths(cell: dict, seed: int) -> np.ndarray:
    n = int(cell["reads"])
    spec = cell["length"]
    if spec["kind"] == "fixed":
        return np.full(n, int(spec["bp"]), np.int64)
    r = np.random.default_rng(int(spec["length_seed"]))
    mean, sd = float(spec["mean"]), float(spec["sd"])
    shape, scale = (mean / sd) ** 2, sd * sd / mean
    lens = np.clip(np.rint(r.gamma(shape, scale, size=n)), spec["min"],
                   spec["max"]).astype(np.int64)
    return rng(seed, 1).permutation(lens)


def _mutate(r: np.random.Generator, src: np.ndarray, lens: np.ndarray,
            error_rate: float) -> list[np.ndarray]:
    """Rows of `src` (bases) read with errors, each cut to its length."""
    B, S = src.shape
    u = r.random((B, S), dtype=np.float32)
    e3 = np.float32(error_rate / 3)
    kind = (u < e3).view(np.uint8) + (u < 2 * e3) + (u < 3 * e3)
    del u
    # kind: 3 substitution, 2 deletion, 1 insertion, 0 copy
    code = _CODE[src]
    sub = np.flatnonzero(kind == 3)
    flat = code.reshape(-1)
    flat[sub] = (flat[sub] + r.integers(1, 4, len(sub), np.uint8)) % 4
    emit = np.array([1, 2, 0, 1], np.int32)[kind]
    at = np.cumsum(emit, axis=1, dtype=np.int32)
    if (at[:, -1] < lens).any():
        raise RuntimeError("source window too short for a read")
    at += np.arange(B, dtype=np.int32)[:, None] * (2 * S) - 1
    out = np.zeros(B * 2 * S, np.uint8)
    kind = kind.reshape(-1)
    at = at.reshape(-1)
    keep = kind != 2
    out[at[keep]] = ACGT[flat[keep]]
    ins = np.flatnonzero(kind == 1)
    out[at[ins] - 1] = r.choice(ACGT, size=len(ins))
    out = out.reshape(B, 2 * S)
    return [out[b, :lens[b]].copy() for b in range(B)]


def reads(cell: dict, strains, seed: int):
    """(ids, sequences) of one call's reads."""
    lens = read_lengths(cell, seed)
    r = rng(seed, 2)
    n = len(lens)
    er = float(cell["error_rate"])
    seqs: list = [None] * n
    pos = np.arange(0, n, 2)
    L = len(strains[0])
    S = int(lens.max(initial=0) * 1.1) + 64
    if S > L:
        raise ValueError("a read is longer than a strain")
    block = max(1, _BLOCK_CELLS // S)
    stacked = np.stack(strains)
    for blk in range(0, len(pos), block):
        idx = pos[blk:blk + block]
        want = lens[idx]
        which = r.integers(0, len(strains), len(idx))
        start = r.integers(0, L - S + 1, len(idx))
        rev = r.random(len(idx)) < 0.5
        src = stacked[which[:, None], start[:, None] + np.arange(S)]
        src[rev] = _COMP[src[rev, ::-1]]
        for j, s in zip(idx, _mutate(r, src, want, er)):
            seqs[j] = s
    neg = np.arange(1, n, 2)
    cuts = np.cumsum(lens[neg])[:-1]
    for j, s in zip(neg, np.split(r.choice(ACGT, size=int(lens[neg].sum())),
                                  cuts)):
        seqs[j] = s
    ids = [f"{'pos' if i % 2 == 0 else 'neg'}_{i}" for i in range(n)]
    return ids, seqs


def write_reads(path: str, ids, seqs) -> int:
    """Writes the FASTA; returns the number of bases in it."""
    with open(path, "wb") as f:
        f.write(b"".join(b">" + i.encode() + b"\n" + s.tobytes() + b"\n"
                         for i, s in zip(ids, seqs)))
    return int(sum(len(s) for s in seqs))
