"""The port's 2- / 4-bit read staging and its device decode (K11 `unpack2`,
K12 `unpack4`): the plain versions equal the JAX package's `_unpack2`,
`_unpack4` and `_decode_alpha` on every in-read column, a staged group
decodes to exactly the 8-bit rows at 2, 4 and 8 bits, and a read holding
byte 0xFF keeps the MS lengths of the native engine. On a GPU the kernels
equal their plain versions exactly.

JAX is imported only inside the parity cases, so the GPU cases also run
on a machine with a GPU and no JAX:
    python -m pytest --noconftest -k gpu tests/test_torch_staging.py
"""

import numpy as np
import pytest
import torch

from spumoni_tpu_torch.engine import kernels
from spumoni_tpu_torch.engine.blockbits import build_blockbits
from spumoni_tpu_torch.engine.layered import build_layered
from spumoni_tpu_torch.engine.occblock import build_occblock
from spumoni_tpu_torch.engine.scan_engine import (ScanEngine, _alpha_table,
                                                  _packed)
from spumoni_tpu_torch.index.format import build_dense_index
from spumoni_tpu_torch.native import NativeQueryEngine, build_raw_index

# decided at setup time, not at import: the string is evaluated per test
needs_cuda = pytest.mark.skipif(
    "not torch.cuda.is_available()",
    reason="CUDA kernel: needs an NVIDIA GPU (sm_90a) and nvcc")

ACGT = np.frombuffer(b"ACGT", np.uint8)


#: (seed, B, L, k): staged widths, then a width of no whole 16-byte vector
#: (Q = 5, H = 10) and one of whole vectors and a tail (Q = 1,025)
_UNPACK_SHAPES = [(0, 7, 128, 0), (1, 33, 256, 40), (2, 5, 8192, 300),
                  (3, 9, 20, 7), (4, 3, 4100, 50)]


@pytest.mark.parametrize("seed,B,L,k", _UNPACK_SHAPES)
def test_plain_unpack_equals_jax(seed, B, L, k):
    """unpack2_reference == _unpack2 (exceptions padded as _stage_exc pads
    them), unpack4_reference == _unpack4 and, with the alphabet's table,
    _decode_alpha(_unpack4): exactly on in-read columns; 0 past them."""
    import jax.numpy as jnp

    from spumoni_tpu.engine.scan_engine import (ScanEngine as JaxScanEngine,
                                                _decode_alpha, _unpack2,
                                                _unpack4)

    packed2, packed4, exc, lens = kernels.seeded_packed(seed, B, L, k)
    inread = np.arange(L)[None, :] < lens[:, None]
    lens_t = torch.from_numpy(lens)
    exc_t = torch.from_numpy(exc) if k else None
    for ranks in ((1, 2, 4, 7), (0, 3, 9, 2), (65, 67, 71, 84)):
        want = np.asarray(_unpack2(jnp.asarray(packed2), ranks,
                                   *JaxScanEngine._stage_exc(
                                       exc if k else None, B)))
        got = kernels.unpack2(torch.from_numpy(packed2), ranks, exc_t,
                              lens_t).numpy()
        assert np.array_equal(got[inread], want[inread])
        assert not got[~inread].any()
    want = np.asarray(_unpack4(jnp.asarray(packed4)))
    got = kernels.unpack4(torch.from_numpy(packed4), lens_t).numpy()
    assert np.array_equal(got[inread], want[inread])
    assert not got[~inread].any()
    alpha = (0, 1, 65, 67, 71, 75, 78, 82, 84, 89, 255)
    want = np.asarray(_decode_alpha(_unpack4(jnp.asarray(packed4)), alpha))
    got = kernels.unpack4(torch.from_numpy(packed4), lens_t,
                          _alpha_table(alpha)).numpy()
    assert np.array_equal(got[inread], want[inread])
    assert not got[~inread].any()


def _text_and_native(seed=21, n=6000):
    rng = np.random.default_rng(seed)
    text = rng.choice(ACGT, n)
    raw = build_raw_index(text)
    dense = build_dense_index(raw, text=text, with_samples=True)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last, text=text)
    return text, dense, native


@pytest.fixture(scope="module")
def dna():
    return _text_and_native()


def _engine(dense, kind, mode="ms"):
    if kind == "layered":
        return ScanEngine(build_layered(dense), mode=mode)
    if kind == "occ":
        return ScanEngine(*build_occblock(dense), mode=mode)
    return ScanEngine(*build_blockbits(dense, want_ms=mode == "ms"),
                      mode=mode)


def _mutate(rng, reads, letters, share):
    """Each read with `share` of its bytes replaced by `letters`."""
    out = []
    for rd in reads:
        a = np.frombuffer(rd, np.uint8).copy()
        hit = rng.random(len(a)) < share
        a[hit] = rng.choice(np.frombuffer(letters, np.uint8), int(hit.sum()))
        out.append(a.tobytes())
    return out


def _case_reads(text, case):
    """40 reads of 130-250 bytes (one bucket, L = 256) drawn from the text,
    with the bytes each case stands for."""
    rng = np.random.default_rng(len(case))
    reads = []
    for m in rng.integers(130, 250, size=40):
        st = int(rng.integers(0, len(text) - m))
        reads.append(text[st:st + m].tobytes())
    if case == "n-iupac":         # a few exceptions
        return _mutate(rng, reads, b"NRYK", 0.01)
    if case == "dense-n":         # more than the exception list holds
        return _mutate(rng, reads, b"NRY", 0.3)
    if case == "wide-alphabet":   # and more than 16 staged symbols
        return _mutate(rng, reads, b"BDEFHIJKLMNOPQRSUVWXYZ", 0.3)
    if case == "byte-255":
        return _mutate(rng, reads, b"N", 0.01) + [b"\xff" + reads[0][1:]]
    if case == "long-read":       # L = 8,192
        return [text[:5000].tobytes() + b"N" + text[100:1200].tobytes()]
    return reads


#: case -> (engine kind -> (bits of the reversed rows, of the forward rows))
_BITS = {
    "acgt": {"bits": (2, 2), "layered": (2, 2)},
    "n-iupac": {"bits": (2, 2), "layered": (2, 2)},
    "dense-n": {"bits": (4, 4), "layered": (8, 8)},
    "wide-alphabet": {"bits": (8, 8), "layered": (8, 8)},
    "byte-255": {"bits": (2, 8), "layered": (8, 8)},
    "long-read": {"bits": (2, 2), "layered": (2, 2)},
}


def _rows8(reads, g, layered):
    """The 8-bit rows of a group: reversed (rank-mapped through the group's
    alphabet, or raw on the layered engine) and forward raw, 0-padded."""
    amap = np.arange(256, dtype=np.uint8)
    if not layered:
        amap = np.zeros(256, np.uint8)
        amap[list(g["alpha"])] = np.arange(len(g["alpha"]))
    rev = np.zeros((len(g["idxs"]), g["L"]), np.uint8)
    fwd = np.zeros_like(rev)
    for j, i in enumerate(g["idxs"]):
        a = np.frombuffer(reads[i], np.uint8)
        rev[j, :len(a)] = amap[a[::-1]]
        fwd[j, :len(a)] = a
    return torch.from_numpy(rev), torch.from_numpy(fwd)


def _check_groups(engine, reads, groups, bits=None):
    for g in groups:
        if bits is not None:
            assert (g["bits"], g["fwd_bits"]) == bits
        rev, fwd = _rows8(reads, g, engine.layered)
        assert torch.equal(engine._rev_d(g), rev)
        assert torch.equal(engine._fwd_d(g), fwd)


@pytest.mark.parametrize("kind", ["bits", "layered"])
@pytest.mark.parametrize("case", sorted(_BITS))
def test_staged_rows_decode_to_the_8_bit_rows(dna, kind, case):
    """Each case stages at the bits of the JAX package's rule (the byte-255
    read's forward rows at 8 bits, the layered rows at 2 or 8), and the
    decoded reversed and forward rows equal the 8-bit rows in the whole
    matrix."""
    text, dense, _ = dna
    engine = _engine(dense, kind)
    reads = _case_reads(text, case)
    groups = engine.stage(_packed(reads))
    assert len(groups) == 1
    if case == "acgt":
        assert groups[0]["exc_d"] is None and groups[0]["fexc_d"] is None
    if case == "n-iupac":
        assert groups[0]["exc_d"].shape[1] == 3
    _check_groups(engine, reads, groups, _BITS[case][kind])


@pytest.mark.parametrize("kind", ["bits", "layered", "occ"])
def test_staged_widths_are_whole_vectors(dna, kind):
    """K11 / K12's vector path covers every staged row: for read lengths 1
    to 3 * CHUNK + 1 every bucket width L that _bucket_L gives holds the
    read and makes Q = L / 4 and H = L / 2 multiples of 16 (whole 16-byte
    vectors, no head or tail on a fresh tensor), and reads of lengths
    across the buckets stage into packed rows of such widths."""
    text, dense, _ = dna
    engine = _engine(dense, kind)
    m = np.arange(1, 3 * engine.CHUNK + 2)
    L = engine._bucket_L(m)
    assert (L >= m).all()
    assert not (L % 64).any()          # Q = L / 4 and H = L / 2: 16 | both
    reads = [text[:n].tobytes() for n in (1, 127, 129, 700, 4097, 5000)]
    reads += _mutate(np.random.default_rng(5), reads, b"N", 0.3)
    for g in engine.stage(_packed(reads)):
        for bits, rows in ((g["bits"], g["rev_p"]),
                           (g["fwd_bits"], g["fwd_p"])):
            assert rows.shape[1] * 8 // bits == g["L"]
            assert bits == 8 or rows.shape[1] % 16 == 0


def test_alphabet_growth_keeps_each_groups_tables(dna):
    """A second batch with new bytes extends the staged alphabet; the first
    batch's groups keep their own alphabet, ranks2 and 4-bit table, and
    decode to their 8-bit rows after the second batch is staged."""
    text, dense, _ = dna
    engine = _engine(dense, "bits")
    first = _case_reads(text, "n-iupac")
    second = _mutate(np.random.default_rng(3), _case_reads(text, "acgt"),
                     b"DHV", 0.3)
    g1 = engine.stage(_packed(first))
    g2 = engine.stage(_packed(second))
    assert set(b"DHV") <= set(g2[0]["alpha"])
    assert not set(b"DHV") & set(g1[0]["alpha"])
    assert g1[0]["ranks2"] != g2[0]["ranks2"]
    assert (g1[0]["bits"], g2[0]["bits"]) == (2, 4)
    _check_groups(engine, first, g1)
    _check_groups(engine, second, g2)


def _reads_255(text):
    """One group (L = 256) holding byte 0xFF (at the read's start, where
    the engines agree: ROADMAP section C), an N-only read, and a read of
    160 bytes with one N where the text has A."""
    p = 250 + int(np.flatnonzero(text[250:300] == ord("A"))[0])
    return [b"\xff" + text[100:300].tobytes(), b"N" * 150,
            text[200:p].tobytes() + b"N" + text[p + 1:360].tobytes()], p


@pytest.mark.parametrize("kind", ["bits", "layered"])
def test_byte_255_keeps_the_native_ms_lengths(dna, kind):
    """A group holding byte 0xFF: its forward rows go at 8 bits, so the MS
    lengths of every read equal the native engine's."""
    text, dense, native = dna
    reads, _ = _reads_255(text)
    engine = _engine(dense, kind)
    (g,) = engine.stage(_packed(reads))
    assert g["fwd_bits"] == 8
    got = engine.query(reads)
    _, want = native.query_ms(reads)
    for g, w in zip(got["lengths"], want):
        assert np.array_equal(g, w)
    assert not want[1].any()


def test_jax_staged_path_reads_byte_255_groups_as_a(dna):
    """The JAX package's divergent answer on the same group, pinned as the
    ROADMAP section C fault the port keeps out: it decodes the group's
    non-ACGT forward bytes as A, so the read whose N stands where the text
    has A matches through the N (length 160 at position 0, where the native
    engine stops at the N)."""
    from spumoni_tpu.engine import blockbits as jbb
    from spumoni_tpu.engine.scan_engine import ScanEngine as JaxScanEngine

    text, dense, native = dna
    reads, p = _reads_255(text)
    arrays, meta, host = jbb.build_blockbits(dense, want_ms=True)
    engine = JaxScanEngine(arrays, meta, mode="ms", host=host)
    got = engine.query_staged(engine.stage(_packed(reads)))["lengths"]
    want = native.query_ms(reads)[1]
    assert (int(got[2][0]), int(want[2][0])) == (160, p - 200)


def _unpack_on_gpu(packed2, packed4, exc, lens, offset=0):
    """K11 (two tables, with the exceptions if any) and K12 (plain and
    through a byte table) on the card equal their plain versions, the
    packed rows uploaded `offset` bytes past a 16-byte boundary."""
    dev = torch.device("cuda")
    p2, p4 = torch.from_numpy(packed2), torch.from_numpy(packed4)
    lens_t = torch.from_numpy(lens)
    exc_t = torch.from_numpy(exc) if len(exc) else None
    d2, d4 = (kernels.misaligned(p.to(dev), offset) for p in (p2, p4))
    for ranks in ((1, 2, 4, 7), (65, 67, 71, 84)):
        got = kernels.unpack2(d2, ranks,
                              None if exc_t is None else exc_t.to(dev),
                              lens_t.to(dev))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), kernels.unpack2_reference(
            p2, ranks, exc_t, lens_t))
    for table in (None, _alpha_table((0, 1, 65, 67, 71, 78, 84, 255))):
        got = kernels.unpack4(d4, lens_t.to(dev), table)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(),
                           kernels.unpack4_reference(p4, lens_t, table))


@needs_cuda
@pytest.mark.parametrize("seed,B,L,k", _UNPACK_SHAPES)
def test_unpack_kernels_equal_plain_versions_on_gpu(seed, B, L, k):
    _unpack_on_gpu(*kernels.seeded_packed(seed, B, L, k))


@needs_cuda
@pytest.mark.parametrize("seed,B,L,k", _UNPACK_SHAPES)
def test_unpack_kernels_on_misaligned_bases_on_gpu(seed, B, L, k):
    """On packed rows 1 byte past a 16-byte boundary (a head and a tail in
    every row), with rows of length 1 and rows ending inside a vector and
    at its edges (kernels.edge_lengths), K11 / K12 equal their plain
    versions."""
    _unpack_on_gpu(*kernels.seeded_packed(seed, B, L, k,
                                          kernels.edge_lengths(B, L)),
                   offset=1)


@needs_cuda
@pytest.mark.parametrize("case", sorted(_BITS))
def test_staged_rows_decode_on_gpu(case):
    """On the card, K11 / K12 decode each case's staged group to its 8-bit
    rows, and the launch counts show which kernel did."""
    text, dense, _ = _text_and_native()
    index, table = build_blockbits(dense, want_ms=True)
    engine = ScanEngine(index.to("cuda"), table, mode="ms")
    reads = _case_reads(text, case)
    (g,) = engine.stage(_packed(reads))
    kernels.reset_launch_counts()
    rev, fwd = engine._rev_d(g), engine._fwd_d(g)
    torch.cuda.synchronize()
    want = {"unpack2": 0, "unpack4": 0}
    for bits in (g["bits"], g["fwd_bits"]):
        if bits != 8:
            want[{2: "unpack2", 4: "unpack4"}[bits]] += 1
    assert {k: kernels.launch_counts()[k] for k in want} == want
    want_rev, want_fwd = _rows8(reads, g, False)
    assert torch.equal(rev.cpu(), want_rev)
    assert torch.equal(fwd.cpu(), want_fwd)
