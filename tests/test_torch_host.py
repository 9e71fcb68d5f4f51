"""Parity of the port's own host layer with the JAX package's: the two
packages' CLIs write byte-identical index files for every build kind, and
the host modules the port copied (FASTA/FASTQ parsing, minimizer
digestion, the KS test, bin-max classification, the report writer) give
the same results on seeded inputs.
"""

import gzip
import hashlib
import os
import shutil

import numpy as np
import pytest

from spumoni_tpu import cli as jax_cli
from spumoni_tpu.classify import binmax as jax_binmax
from spumoni_tpu.classify import kstest as jax_kstest
from spumoni_tpu.classify import report as jax_report
from spumoni_tpu.glibc_rand import GlibcRand as JaxGlibcRand
from spumoni_tpu.index.null_db import EmpNullDatabase as JaxNullDatabase
from spumoni_tpu.io import fasta as jax_fasta
from spumoni_tpu.io import fastx_batch as jax_fastx_batch
from spumoni_tpu.io import minimizers as jax_minimizers

from spumoni_tpu_torch import cli
from spumoni_tpu_torch.classify import binmax, kstest, report
from spumoni_tpu_torch.glibc_rand import GlibcRand
from spumoni_tpu_torch.index.null_db import EmpNullDatabase
from spumoni_tpu_torch.io import fasta, fastx_batch, minimizers

from test_pipeline import _write_genome

#: build kind -> its CLI runs; "{ref}" and "{list}" name the inputs,
#: "{text}" a copy of the general text in the output directory (-g writes
#: the index next to it), "{out}" the output prefix
_BUILDS = {
    "P-n": [["build", "-r", "{ref}", "-P", "-n", "-o", "{out}"]],
    "list-M-P-d-n": [["build", "-i", "{list}", "-M", "-P", "-d", "-n", "-o",
                      "{out}"]],
    "m-P": [["build", "-r", "{ref}", "-m", "-P", "-o", "{out}"]],
    "a-P": [["build", "-r", "{ref}", "-a", "-P", "-o", "{out}"]],
    "g-M-P": [["build", "-r", "{text}", "-g", "-M", "-P", "-o", "{out}"]],
    "emit-ref-formats-import-ref": [
        ["build", "-r", "{ref}", "-M", "-P", "-n", "--emit-ref-formats",
         "-o", "{out}"],
        ["import-ref", "-r", "{out}.fa", "-M", "-P"]],
}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A two-contig genome, three single-contig documents and their file
    list, and a general text of 26 letters."""
    tmp = tmp_path_factory.mktemp("inputs")
    rng = np.random.default_rng(5)
    paths = {"ref": str(tmp / "ref.fa"), "list": str(tmp / "files.txt"),
             "text": str(tmp / "corpus.txt")}
    _write_genome(paths["ref"], rng)
    with open(paths["list"], "w") as f:
        for d in range(3):
            doc = str(tmp / f"doc{d}.fa")
            _write_genome(doc, rng, contigs=((f"seq{d}", 4000 + 500 * d),))
            f.write(f"{doc} {d + 1}\n")
    with open(paths["text"], "wb") as f:
        f.write(rng.integers(97, 123, size=12000, dtype=np.uint8).tobytes())
    return paths


def _hashes(directory):
    out = {}
    for root, _, names in os.walk(directory):
        for name in names:
            path = os.path.join(root, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, directory)] = hashlib.sha256(
                    f.read()).hexdigest()
    return out


@pytest.mark.parametrize("kind", sorted(_BUILDS))
def test_build_writes_the_jax_packages_files(inputs, tmp_path, kind):
    """Every file the JAX package's CLI writes, the port's CLI writes with
    the same bytes (index, null databases, statistics, the built reference,
    the reference-format intermediates and the imported indexes)."""
    got = {}
    for name, main in (("jax", jax_cli.main), ("port", cli.main)):
        out_dir = tmp_path / name
        out_dir.mkdir()
        fill = dict(inputs, out=str(out_dir / "idx"),
                    text=str(out_dir / "corpus.txt"))
        shutil.copy(inputs["text"], fill["text"])
        for argv in _BUILDS[kind]:
            assert main([a.format(**fill) for a in argv]) == 0
        got[name] = _hashes(out_dir)
    assert any(".thrbv." in f for f in got["jax"])
    assert got["port"] == got["jax"]


def _fastx_files(tmp_path):
    """The same seeded reads as FASTA (wrapped lines, lower case, N,
    descriptions), FASTQ and gzipped FASTQ."""
    rng = np.random.default_rng(11)
    letters = np.frombuffer(b"ACGTNacgtRY", np.uint8)
    reads = [rng.choice(letters, int(m)).tobytes()
             for m in rng.integers(1, 700, size=40)]
    fa = b"".join(b">r%d desc %d\n" % (i, i) + b"\n".join(
        rd[j:j + 60] for j in range(0, len(rd), 60)) + b"\n"
        for i, rd in enumerate(reads))
    fq = b"".join(b"@q%d x\n%s\n+\n%s\n" % (i, rd, b"I" * len(rd))
                  for i, rd in enumerate(reads))
    paths = {"fasta": tmp_path / "r.fa", "fastq": tmp_path / "r.fq",
             "gzip": tmp_path / "r.fq.gz"}
    paths["fasta"].write_bytes(fa)
    paths["fastq"].write_bytes(fq)
    with gzip.open(paths["gzip"], "wb") as f:
        f.write(fq)
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("fmt", ["fasta", "fastq", "gzip"])
def test_read_fastx_matches_jax(tmp_path, fmt):
    path = _fastx_files(tmp_path)[fmt]
    want = [(r.name, r.seq, r.qual, r.header)
            for r in jax_fasta.read_fastx(path)]
    assert len(want) == 40
    assert [(r.name, r.seq, r.qual, r.header)
            for r in fasta.read_fastx(path)] == want


@pytest.mark.parametrize("fmt", ["fasta", "fastq", "gzip"])
@pytest.mark.parametrize("upper", [False, True])
def test_iter_packed_batches_matches_jax(tmp_path, fmt, upper):
    path = _fastx_files(tmp_path)[fmt]
    want = list(jax_fastx_batch.iter_packed_batches(path, 3000, upper=upper))
    got = list(fastx_batch.iter_packed_batches(path, 3000, upper=upper))
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        assert g.ids == w.ids
        assert np.array_equal(g.buf, w.buf)
        assert np.array_equal(g.offs, w.offs)


def _digest_batch(kind, k, w):
    """(reads, buf, offs) of a batch for the digest cases: "edges" holds
    zero-length reads (first, inside, last), reads shorter than k, reads
    with k <= len < w and of exactly w, runs of N, an N first or last, a
    read all N and one all T; "errors" 64 reads of 1,024 bp with 8% of the bases replaced by
    substitutions, N or lower case."""
    rng = np.random.default_rng(7 + k * 100 + w)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    if kind == "edges":
        reads = [b"", rng.choice(acgt, k - 1).tobytes(), b"",
                 rng.choice(acgt, k).tobytes(),
                 rng.choice(acgt, max(k, w - 1)).tobytes(),
                 rng.choice(acgt, w).tobytes(), b"N" * (3 * w),
                 rng.choice(acgt, 40).tobytes() + b"N" * (w + 2)
                 + rng.choice(acgt, 50).tobytes(),
                 b"NN" + rng.choice(acgt, w + 3).tobytes() + b"N",
                 b"N" + rng.choice(acgt, w + 5).tobytes(),
                 b"T" * (2 * w), rng.choice(acgt, 300).tobytes(), b""]
    else:
        reads = []
        for _ in range(64):
            rd = rng.choice(acgt, 1024)
            err = np.flatnonzero(rng.random(1024) < 0.08)
            rd[err] = rng.choice(np.frombuffer(b"ACGTNacg", np.uint8),
                                 len(err))
            reads.append(rd.tobytes())
    offs = np.zeros(len(reads) + 1, np.int64)
    np.cumsum([len(rd) for rd in reads], out=offs[1:])
    return reads, np.frombuffer(b"".join(reads), np.uint8).copy(), offs


#: (promotions, dna, k, w, batch): the 40 seeded reads of _fastx_files at
#: the defaults, then both schemes at four (k, w) on the two batches of
#: _digest_batch ((5, 5) is one k-mer a window)
_DIGEST_CASES = [
    pytest.param(True, False, 4, 11, "fasta", id="True-False"),
    pytest.param(False, True, 4, 11, "fasta", id="False-True"),
] + [
    pytest.param(promotions, not promotions, k, w, batch,
                 id=f"{'m' if promotions else 'a'}-k{k}w{w}-{batch}")
    for promotions in (True, False)
    for k, w in ((4, 11), (3, 7), (5, 5), (8, 20))
    for batch in ("edges", "errors")]


@pytest.mark.parametrize("promotions,dna,k,w,batch", _DIGEST_CASES)
def test_digest_and_digest_packed_match_jax(tmp_path, promotions, dna, k, w,
                                            batch):
    """The native pass gives the JAX package's digests byte for byte, on
    a whole batch and read by read."""
    if batch == "fasta":
        path = _fastx_files(tmp_path)["fasta"]
        (want_pk,) = jax_fastx_batch.iter_packed_batches(path, 1 << 30,
                                                         upper=True)
        (pk,) = fastx_batch.iter_packed_batches(path, 1 << 30, upper=True)
    else:
        _, buf, offs = _digest_batch(batch, k, w)
        ids = [f"r{i}" for i in range(len(offs) - 1)]
        pk = fastx_batch.PackedReads(ids, buf, offs)
        want_pk = jax_fastx_batch.PackedReads(list(ids), buf.copy(),
                                              offs.copy())
    got = minimizers.digest_packed(pk, promotions, dna, k, w)
    want = jax_minimizers.digest_packed(want_pk, promotions, dna, k, w)
    assert got.ids == want.ids
    assert np.array_equal(got.buf, want.buf)
    assert np.array_equal(got.offs, want.offs)
    if batch != "fasta":
        assert len(got.buf) > 0
    for i in range(len(pk)):
        rd = pk.buf[pk.offs[i]:pk.offs[i + 1]].tobytes()
        assert minimizers.digest(rd, promotions, dna, k, w) == \
            jax_minimizers.digest(rd, promotions, dna, k, w)


@pytest.mark.parametrize("promotions", [True, False])
def test_digest_rejects_k_below_one(promotions):
    with pytest.raises(ValueError):
        minimizers.digest(b"ACGTACGTACGT", promotions, not promotions, 0, 11)


def _values(seed, n=30):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 40, size=int(m)) for m in
            rng.integers(1, 900, size=n)]


def test_kstest_with_glibc_rand_matches_jax():
    """KSTest draws its null windows from rand() after srand(0): the same
    draws and statistics, read after read, and the same window counts."""
    stats = np.random.default_rng(3).integers(0, 25, size=5000)
    got = kstest.KSTest(EmpNullDatabase(stats), 150, rand=GlibcRand(0))
    want = jax_kstest.KSTest(JaxNullDatabase(stats), 150,
                             rand=JaxGlibcRand(0))
    vals = _values(4)
    for v in vals:
        assert got.run_kstest(v) == want.run_kstest(v)
    lens = np.array([len(v) for v in vals])
    assert np.array_equal(kstest.n_windows_batch(lens, 150),
                          jax_kstest.n_windows_batch(lens, 150))


@pytest.mark.parametrize("bin_width,thr", [(150, 9), (50, 20)])
def test_binmax_classify_matches_jax(bin_width, thr):
    for v in _values(6):
        got = binmax.classify(v, bin_width, thr)
        want = jax_binmax.classify(v, bin_width, thr)
        assert (got.status, got.bins_above, got.bins_below) == \
            (want.status, want.bins_above, want.bins_below)
        assert np.array_equal(got.bin_maxes, want.bin_maxes)
    assert binmax.max_value_threshold(17.0, False, False, "pml") == \
        jax_binmax.max_value_threshold(17.0, False, False, "pml")


def test_report_lines_match_jax():
    rng = np.random.default_rng(8)
    for i in range(50):
        args = (f"read_{i}", "FOUND" if i % 3 else "NOT_PRESENT",
                float(rng.random() * 10 ** int(rng.integers(-3, 5))),
                int(rng.integers(0, 40)), int(rng.integers(0, 40)))
        assert report.report_line(*args) == jax_report.report_line(*args)
        assert report.ks_report_line(*args) == \
            jax_report.ks_report_line(*args)
    assert report.report_header(12) == jax_report.report_header(12)
    assert report.ks_report_header(0.25) == jax_report.ks_report_header(0.25)
