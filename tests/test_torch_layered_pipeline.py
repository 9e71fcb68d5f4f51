"""End-to-end parity of the port's `run` (device='cpu': the plain PyTorch
versions) with the JAX package's `run` (JAX CPU backend) on the layered
engine: `--engine layered` on a three-document -M -P -d index,
minimizer-digested indexes (`-m`, which the layered engine serves, and
`-a`, which block-bits serves), and general text (`-g`). Output files are
byte-identical; the engine each package picks is the same.
"""

import os

import numpy as np
import pytest

from spumoni_tpu.pipeline import BuildConfig, RunConfig as JaxRunConfig
from spumoni_tpu.pipeline import _make_engine, build, load_dense_index
from spumoni_tpu.pipeline import run as jax_run

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch.engine.blockbits import BlockBitsIndex

from test_pipeline import _write_genome, _write_reads
from test_torch_pipeline import _VALUE_EXTS, _clear, _outputs, msdoc  # noqa


def _run_both(base, n_reads, **kw):
    """Runs JAX, then the port, on the same config; returns both runs'
    output files."""
    reads_path = base["pattern_file"]
    _clear(reads_path)
    n_jax = jax_run(JaxRunConfig(**base, **kw))
    want = _outputs(reads_path, _VALUE_EXTS)
    _clear(reads_path)
    n_port = tpl.run(tpl.RunConfig(device="cpu", **base, **kw))
    assert n_jax == n_port == n_reads
    return want, _outputs(reads_path, _VALUE_EXTS)


def _resume_both(base, n_reads, keep_reads, **kw):
    """The JAX run's files cut to keep_reads durable reads, then the port's
    --resume; returns (JAX files, resumed files)."""
    reads_path = base["pattern_file"]
    _clear(reads_path)
    assert jax_run(JaxRunConfig(**base, **kw)) == n_reads
    want = _outputs(reads_path, _VALUE_EXTS)
    for e, data in want.items():
        keep = keep_reads + 1 if e == ".report" else 2 * keep_reads
        with open(reads_path + e, "wb") as f:
            f.write(b"".join(data.splitlines(True)[:keep]))
    with open(reads_path + ".cursor", "w") as f:
        f.write(str(keep_reads))
    assert tpl.run(tpl.RunConfig(device="cpu", resume=True, **base,
                                 **kw)) == n_reads
    return want, _outputs(reads_path, _VALUE_EXTS)


_LAYERED_RUNS = {
    "P-c": dict(pml_requested=True, write_report=True),
    "P-c-report-only": dict(pml_requested=True, write_report=True,
                            report_only=True),
    "P-c-ks-report": dict(pml_requested=True, write_report=True,
                          ks_report=True),
    "M-c-report-only": dict(ms_requested=True, write_report=True,
                            report_only=True),
    "M-c-d": dict(ms_requested=True, write_report=True, use_doc=True),
    "P-d-c": dict(pml_requested=True, use_doc=True, write_report=True),
}


@pytest.mark.parametrize("run_id", sorted(_LAYERED_RUNS))
def test_layered_runs_match_jax(msdoc, run_id):  # noqa: F811
    """`--engine layered` writes the files of the JAX package's layered
    engine, byte for byte (K8; K7; K7 -> K4 -> K5; K7 -> K4; K7)."""
    kw = _LAYERED_RUNS[run_id]
    want, got = _run_both(msdoc, 13, engine="layered", **kw)
    assert want and got == want


@pytest.mark.parametrize("run_id", ["M-c-d", "P-c-ks-report"])
def test_layered_resume_continues_the_files(msdoc, run_id):  # noqa: F811
    want, got = _resume_both(msdoc, 13, 4, engine="layered",
                             **_LAYERED_RUNS[run_id])
    assert got == want


@pytest.fixture(scope="module")
def digested(tmp_path_factory):
    """-m and -a indexes (build -P) of one genome, and reads: substrings
    at 2% error, random reads, an N run, and a read shorter than one
    minimizer window's span."""
    tmp = tmp_path_factory.mktemp("digested")
    rng = np.random.default_rng(23)
    genome_path = str(tmp / "genome.fa")
    seqs = _write_genome(genome_path, rng, contigs=(("chr1", 30000),))
    genome = "".join(seqs.values())
    reads_path = str(tmp / "reads.fa")
    _write_reads(reads_path, rng, genome, n_pos=5, n_neg=4, m=500, err=0.02)
    with open(reads_path, "a") as f:
        f.write(">with_n\n" + genome[900:1300] + "N" * 20 + genome[50:300]
                + "\n")
        f.write(">short\n" + genome[4000:4030] + "\n")
    out = {}
    for flag in ("use_promotions", "use_dna_letters"):
        prefix = str(tmp / f"idx_{flag}")
        build(BuildConfig(ref_file=genome_path, output_prefix=prefix,
                          pml_index=True, **{flag: True}))
        out[flag] = dict(ref_file=prefix, pattern_file=reads_path,
                         **{flag: True})
    return out


_DIGESTED_RUNS = {
    "m-P-c": ("use_promotions", dict(write_report=True)),
    "m-P-c-report-only": ("use_promotions", dict(write_report=True,
                                                 report_only=True)),
    "m-P-c-ks-report": ("use_promotions", dict(write_report=True,
                                               ks_report=True)),
    "a-P-c": ("use_dna_letters", dict(write_report=True)),
    "a-P-c-report-only": ("use_dna_letters", dict(write_report=True,
                                                  report_only=True)),
    "a-P-c-ks-report": ("use_dna_letters", dict(write_report=True,
                                                ks_report=True)),
}


@pytest.mark.parametrize("run_id", sorted(_DIGESTED_RUNS))
def test_digested_runs_match_jax(digested, run_id):
    """`run -m` (layered engine: sigma > 8) and `run -a` (block-bits)
    digest each batch before staging and write the JAX package's files;
    --ks-report counts its windows on the digested lengths."""
    flag, kw = _DIGESTED_RUNS[run_id]
    want, got = _run_both(digested[flag], 11, pml_requested=True, **kw)
    assert ".report" in want and got == want
    found = [ln.split()[1] for ln in want[".report"].decode().splitlines()[1:]]
    assert found[:5].count("FOUND") >= 4 and "FOUND" not in found[5:9]


def test_digested_ks_report_resume(digested):
    """--resume of a -m --ks-report run owes the skipped reads' rand()
    draws by their digested window counts."""
    want, got = _resume_both(digested["use_promotions"], 11, 3,
                             pml_requested=True, write_report=True,
                             ks_report=True)
    assert got == want


@pytest.fixture(scope="module")
def general(tmp_path_factory):
    """A general-text index (build -g -M -P) of 24 kB over a-z, and
    \\x01-separated queries: substrings, a random string, an empty record,
    a record with bytes absent from the text, and a trailing chunk that
    has no separator (never emitted)."""
    tmp = tmp_path_factory.mktemp("general")
    rng = np.random.default_rng(29)
    data = bytes(rng.integers(97, 123, size=24000).astype(np.uint8))
    ref_path = str(tmp / "corpus.txt")
    with open(ref_path, "wb") as f:
        f.write(data)
    queries = [data[500:800], data[10000:10400],
               bytes(rng.integers(97, 123, size=300).astype(np.uint8)), b"",
               data[3000:3100] + b"ZZ#" + data[7000:7200], data[-150:]]
    pattern_path = str(tmp / "queries.txt")
    with open(pattern_path, "wb") as f:
        f.write(b"\x01".join(queries) + b"\x01" + data[:50])
    build(BuildConfig(ref_file=ref_path, output_prefix=str(tmp / "idx"),
                      ms_index=True, pml_index=True, is_general_text=True,
                      use_minimizers=False))
    return dict(ref_file=ref_path, pattern_file=pattern_path,
                is_general_text=True, min_digest=False)


@pytest.mark.parametrize("mode", ["pml_requested", "ms_requested"])
def test_general_text_runs_match_jax(general, mode):
    """`run -g -P|-M` streams the records through the layered engine and
    writes the JAX package's value files (no report)."""
    want, got = _run_both(general, 6, **{mode: True})
    exts = {".pseudo_lengths"} if mode == "pml_requested" else {
        ".lengths", ".pointers"}
    assert set(want) == exts and got == want
    assert want[min(exts)].split(b"\n")[7] == b""     # the empty record


def test_general_text_resume(general):
    want, got = _resume_both(general, 6, 2, ms_requested=True)
    assert got == want


@pytest.mark.parametrize("mode,use_doc", [("pml", False), ("pml", True),
                                          ("ms", False), ("ms", True)])
def test_auto_engine_choice_matches_jax(msdoc, digested, mode,  # noqa: F811
                                        use_doc):
    """With --engine auto the port picks the engine the JAX package's
    _make_engine picks: block-bits for the DNA index in every mode, the
    layered engine for the -m index (sigma > 8)."""
    cases = [(msdoc["ref_file"] + ".fa.thrbv."
              + ("ms" if mode == "ms" else "spumoni"), use_doc)]
    if not use_doc and mode == "pml":
        cases.append((digested["use_promotions"]["ref_file"]
                      + ".bin.thrbv.spumoni", False))
    for path, doc in cases:
        dense = load_dense_index(path)
        cfg = JaxRunConfig(ref_file="", pattern_file="",
                           **{f"{mode}_requested": True}, use_doc=doc)
        jax_bits = hasattr(_make_engine(cfg, dense).arrays, "bblocks")
        port = tpl.make_engine(path, tpl.select_devices("cpu")[0], mode, doc,
                               fast_start=False)
        assert isinstance(port.index, BlockBitsIndex) == jax_bits, path
        assert port.layered == (not jax_bits)
