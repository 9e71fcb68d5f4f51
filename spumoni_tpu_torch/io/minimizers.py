"""Minimizer digestion schemes.

Re-implements the two digestion modes of src/spumoni.cpp:294-342
with bonsai's minimizer semantics (the reference delegates to
bns::RollingHasher / bns::Encoder<bns::score::Lex> from the bonsai library,
fetched at configure time — thirdparty/CMakeLists.txt:60-72):

  * window geometry: `w` is the window SPAN IN BASES (bonsai Spacer(k, w)
    requires w >= k); each window position i in [0, len-w] covers the
    w - k + 1 k-mers starting at i..i+w-k, and ONE minimizer is emitted per
    window position (duplicates across sliding positions are then collapsed
    by SPUMONI's homopolymer compression, spumoni.cpp:306,334);
  * invalid bases: a k-mer containing any non-ACGT base is invalid (bonsai
    encodes it as the sentinel BF = 2^64-1, the worst possible score) — it
    never wins a window, and a window with no valid k-mer emits nothing;
  * sequences shorter than one window but >= k are treated as a single
    truncated window over the available k-mers;
  * promotion scheme (`-m`, spumoni.cpp:294-319): each window minimizer is
    an 8-BIT ROLLING HASH of the k-mer (bns::RollingHasher<uint8_t>) — one
    byte of digested text per (compressed) minimizer, with values 0-2
    remapped +3 to reserve the PFP special symbols (spumoni.cpp:311).
    Compression happens on the RAW hash value before the remap
    (spumoni.cpp:305-311); x and x+3 therefore do NOT merge, which this
    module preserves by compressing before remapping (equivalent order);
  * DNA-letter scheme (`-a`, spumoni.cpp:321-342): the window minimizer is
    the lexicographically smallest k-mer under the 2-bit encoding
    A=0 < C=1 < G=2 < T=3 (bns::score::Lex), re-expanded to its ACGT text
    (bns::Spacer::to_string). This scheme is exact per bonsai's published
    algorithm: the emitted value IS the k-mer, so tie-breaking between
    equal-scoring positions cannot change the output.

Deviation note (promotion scheme only): the reference's 8-bit hash is
rollinghashcpp's CyclicHash — a rotate-xor hash over a per-character table
filled by `CharacterHash(maxval)` from Wagner's MTRand Mersenne Twister.
The hash STRUCTURE (cyclic rotate-xor, window-min, invalid handling) is
reproduced exactly, and the character table is now DERIVED per the published
generation chain (io/mtrand.py: bit-exact MT19937 with Wagner's
initialize/reload/tempering + randInt(255) masking, indexed by bonsai's
bns::DNA 2-bit codes). The one quantity not derivable offline is the pinned
MT seed (upstream's default seeding is process-random, which a working
build/run pair cannot use); seed 0 is the convention here, and digested
indexes remain self-consistent (build and run share this module) whatever
the deployed fork pins. See io/mtrand.py's docstring + PARITY.md.

The work is one native pass per read (csrc/minimizers.cpp, through
native.digest_reads): a rolling hash or 2-bit code, each window's minimum,
the compression and the remap or expansion, with the interpreter lock
released. Every entry point here reaches that pass.
"""

from __future__ import annotations

import os

import numpy as np

from .. import native
from .mtrand import character_hash_table

# per-base table for the 8-bit cyclic hash, derived via the published
# CharacterHash(255) + Wagner-MTRand chain (see deviation note). bonsai's
# bns::DNA mode feeds the hasher 2-bit base codes, so the effective entries
# are hashvalues[0..3], those of A, C, G, T.
# SPN_PROMO_SEED overrides the pinned MT seed (default 0) for users who
# have extracted their deployed bonsai fork's constant — the one quantity
# not derivable offline (PARITY.md deviation 1, round-5 resolution).
_PROMO_SEED = int(os.environ.get("SPN_PROMO_SEED", "0"))
_HASH4 = np.ascontiguousarray(
    character_hash_table(wordsize=8, seed=_PROMO_SEED)[:4], dtype=np.uint8)


def _digest_bytes(seq, dna: bool, k: int, w: int) -> bytes:
    arr = np.frombuffer(bytes(seq), dtype=np.uint8)
    out, _ = native.digest_reads(arr, np.array([0, len(arr)], np.int64),
                                 dna, k, w, _HASH4)
    return out.tobytes()


def digest_promotion(seq: bytes, k: int = 4, w: int = 11) -> bytes:
    """Alphabet-promotion digestion: one byte per (compressed) window
    minimizer hash (spumoni.cpp:294-319)."""
    return _digest_bytes(seq, False, k, w)


def digest_dna(seq: bytes, k: int = 4, w: int = 11) -> bytes:
    """DNA-letter digestion: lexicographically smallest k-mer per window,
    expanded back to ACGT text (spumoni.cpp:321-342)."""
    return _digest_bytes(seq, True, k, w)


def digest(seq: bytes, use_promotions: bool, use_dna_letters: bool,
           k: int = 4, w: int = 11) -> bytes:
    if use_promotions:
        return digest_promotion(seq, k, w)
    if use_dna_letters:
        return digest_dna(seq, k, w)
    return bytes(seq)


def digest_packed(p, use_promotions: bool, use_dna_letters: bool,
                  k: int = 4, w: int = 11):
    """Digest every read of a PackedReads batch: the batch's bytes and
    offsets go to the native pass whole, which digests read by read (no
    window crosses a read's bounds), so each read's digest equals
    digest() of it."""
    from .fastx_batch import PackedReads

    if not use_promotions and not use_dna_letters:
        return p
    out, offs = native.digest_reads(p.buf, p.offs, not use_promotions, k, w,
                                    _HASH4)
    return PackedReads(p.ids, out, offs)
