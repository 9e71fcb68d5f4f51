"""The plain reference against the port's `--device cpu` runs on a tiny
pangenome, for each cell's flags, and its parts against brute force and the
port's own copies of the same algorithms."""

import numpy as np
import pytest

from benchmark import run
from benchmark.reference import digest, rng
from benchmark.reference.deployment import binmax
from benchmark.reference.index import TextIndex
from benchmark.reference.suffix_array import suffix_array
from conftest import CELLS, tiny


@pytest.mark.parametrize("traffic", CELLS)
def test_reference_equals_the_port_on_cpu(traffic, tmp_path):
    workload, cfg, cell = tiny(traffic)
    res = run.run_cell(workload, 2**35 + 11, 0.2, False, device="cpu",
                       config=cfg, cell=cell, work=str(tmp_path / "w"))
    checks = res["checks"]
    assert res["correct"], checks
    assert all(c["limit"] == 0 for c in checks.values())
    assert "report_lines_wrong" in checks
    assert ("value_records_wrong" in checks) == (
        "--report-only" not in cell["flags"])


@pytest.mark.parametrize("alphabet,size", [(b"AC", 300), (b"ACGT", 2000),
                                           (bytes(range(3, 200)), 1500)])
def test_suffix_array_brute_force(alphabet, size):
    r = np.random.default_rng(size)
    a = np.frombuffer(alphabet, np.uint8)
    s = np.append(r.choice(a, size), np.uint8(0))
    s[size // 2:size // 2 + 100] = s[:100]          # a long repeat
    want = sorted(range(len(s)), key=lambda i: s[i:].tobytes())
    assert suffix_array(s).tolist() == want


def test_rng_against_the_port():
    from spumoni_tpu_torch.glibc_rand import GlibcRand
    from spumoni_tpu_torch.io.mtrand import MTRand, character_hash_table

    a, b = rng.GlibcRand(0), GlibcRand(0)
    assert [a.rand() for _ in range(5000)] == [b.rand() for _ in range(5000)]
    m = MTRand(0)
    words = rng.mt19937_words(0, 1300)          # two reloads
    assert words == [m.rand_int32() for _ in range(1300)]
    tab = character_hash_table(wordsize=8, seed=0)
    assert [w & 0xFF for w in words[:256]] == tab.tolist()


def test_digest_against_the_port():
    from spumoni_tpu_torch.io.minimizers import digest as port_digest

    r = np.random.default_rng(3)
    for n in (4, 7, 11, 12, 500, 5000):
        s = r.choice(np.frombuffer(b"ACGTN", np.uint8), n,
                     p=[0.24, 0.24, 0.24, 0.24, 0.04])
        want = np.frombuffer(port_digest(s.tobytes(), True, False), np.uint8)
        assert np.array_equal(digest.digest(s), want)


def test_walks_on_a_text_with_ties():
    """PML and MS of reads over a repetitive text, against the native CPU
    engine of the port (its own recurrence over thresholds)."""
    from spumoni_tpu_torch.native import NativeQueryEngine, build_raw_index

    r = np.random.default_rng(8)
    unit = r.choice(np.frombuffer(b"ACGT", np.uint8), 40)
    text = np.concatenate([unit, unit, r.choice(np.frombuffer(b"ACGT",
                                                              np.uint8), 300),
                           unit[:25], unit])
    raw = build_raw_index(text)
    eng = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                            raw.thresholds, raw.samples_start,
                            raw.samples_last, text=text)
    reads = [r.choice(np.frombuffer(b"ACGT", np.uint8), 60) for _ in range(30)]
    reads += [text[i:i + 50].copy() for i in range(0, 300, 17)]
    idx = TextIndex(text)
    pml = idx.pml(reads)
    ptr, lens, _ = idx.ms(reads)
    want = eng.query_pml([x.tobytes() for x in reads])
    wptr, wlen = eng.query_ms([x.tobytes() for x in reads])
    for i in range(len(reads)):
        assert np.array_equal(pml[i], want[i])
        assert np.array_equal(ptr[i], wptr[i])
        assert np.array_equal(lens[i], wlen[i])


@pytest.mark.parametrize("m", [1, 149, 150, 151, 299, 300, 301, 1024])
def test_binmax_against_the_port(m):
    from spumoni_tpu_torch.classify import binmax as port

    v = np.random.default_rng(m).integers(0, 30, m)
    res = port.classify(v, 150, 12)
    assert binmax(v, 150, 12) == (res.status == "FOUND", res.avg_max,
                                  res.bins_above, res.bins_below)


def test_sample_holds_the_longest_read():
    ids = [f"r{i}" for i in range(50)]
    seqs = [np.zeros(i % 7 + (40 if i == 33 else 0)) for i in range(50)]
    picks = run.sample_reads(ids, seqs, 5, 9)
    assert 33 in picks and 5 <= len(picks) <= 6
    assert picks == run.sample_reads(ids, seqs, 5, 9)
