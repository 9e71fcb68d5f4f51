"""End-to-end parity of the port's `run` (device='cpu': the plain PyTorch
versions) with the JAX package's `run` (JAX CPU backend) on the layered
engine: `--engine layered` on a three-document -M -P -d index,
minimizer-digested indexes (`-m`, which the layered engine serves, and
`-a`, which block-bits serves), and general text (`-g`). Output files are
byte-identical; the engine each package picks is the same.
"""

import os
import re

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
    """-m and -a indexes (build -P) and a -m -M index of one genome (its
    text under "genome"), and reads: substrings at 2% error, random reads,
    an N run, and a read shorter than one minimizer window's span. No
    read's digest holds a symbol past the -m indexes' last."""
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
    prefix = str(tmp / "idx_ms")
    build(BuildConfig(ref_file=genome_path, output_prefix=prefix,
                      ms_index=True, use_promotions=True))
    out["use_promotions_ms"] = dict(ref_file=prefix, pattern_file=reads_path,
                                    use_promotions=True)
    out["genome"] = genome
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


_DIGESTED_MS_RUNS = {
    "m-M-c": dict(ms_requested=True, write_report=True),
    "m-M-c-report-only": dict(ms_requested=True, write_report=True,
                              report_only=True),
}


@pytest.mark.parametrize("run_id", sorted(_DIGESTED_MS_RUNS))
def test_digested_ms_runs_match_jax(digested, run_id):
    """`run -m -M` (layered engine: K7 in MS mode, K4 over the digested
    text, K5 for the report only) writes the JAX package's files on reads
    whose digests stay inside the index's symbols."""
    base = digested["use_promotions_ms"]
    dense = tpl.load_dense_index(base["ref_file"] + ".bin.thrbv.ms")
    digests = _digests(_fasta(base["pattern_file"])).values()
    assert max(max(d) for d in digests if d) <= _last_symbol(dense)
    want, got = _run_both(base, 11, **_DIGESTED_MS_RUNS[run_id])
    assert ".report" in want and got == want
    assert (".lengths" in want) == (run_id == "m-M-c")


def _fasta(path) -> dict:
    with open(path) as f:
        lines = f.read().split()
    return {lines[i][1:]: lines[i + 1].encode()
            for i in range(0, len(lines), 2)}


def _digests(reads: dict) -> dict:
    from spumoni_tpu_torch.io.minimizers import digest_promotion
    return {rid: digest_promotion(rd) for rid, rd in reads.items()}


def _last_symbol(dense) -> int:
    return int(max(np.nonzero(np.asarray(dense.cnt))[0]))


def _value_records(path) -> dict:
    """{read id: int64 values} of a value file (printed as unsigned
    64-bit)."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return {lines[i][1:].decode(): np.array(lines[i + 1].split(),
                                            np.uint64).view(np.int64)
            for i in range(0, len(lines) - 1, 2)}


def _report_lines(path, values: dict) -> tuple:
    """(the report's lines, the lines of `values` by the host bin-max at
    the header's threshold)."""
    from spumoni_tpu_torch.classify import binmax, report
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    thr = int(re.search(r"thr=(\d+)", lines[0]).group(1))
    want = [lines[0]]
    for rid, v in values.items():
        res = binmax.classify(v, 150, thr)
        want.append(report.report_line(rid, res.status, res.avg_max,
                                       res.bins_above, res.bins_below))
    return lines, want


#: reads of G runs (an int: its length) and genome slices ((start, end)):
#: a G run's GGGG hashes above the -m index's last symbol and wins its
#: windows. Inside a read; at its ends (its last symbol is the backward
#: walk's first); two in one read, 20 bases apart
_G_RUN_READS = {
    "inside": ([(100, 400), 16, (450, 650)], [(5000, 5040), 12, (5090, 5290)],
               [(9000, 9600), 30, (9650, 9850)], [14, (20050, 20250)]),
    "at_the_ends": ([(3000, 3400), 16], [20, (15000, 15300), 20], [40]),
    "twice": ([(7000, 7300), 16, (7350, 7550), 16, (7600, 7800)],
              [(11000, 11200), 14, (11210, 11230), 14, (11300, 11500)]),
}


@pytest.mark.parametrize("case", sorted(_G_RUN_READS))
def test_digested_runs_past_the_last_symbol_follow_native(digested, case,
                                                          tmp_path):
    """Reads whose digests hold a symbol past every symbol of the -m index
    (_G_RUN_READS) leave the BWT there. The plain layered step (K7's, in
    PML and MS, with K4's extension) and the whole `run -m -M -c` and `run
    -m -P -c` on the CPU give the native engine's values over the index's
    text, and report lines of their bin-max."""
    from spumoni_tpu_torch.engine import kernels
    from spumoni_tpu_torch.engine.layered import build_layered, raw_rows
    from spumoni_tpu_torch.native import NativeQueryEngine, build_raw_index

    genome = digested["genome"]
    reads = {f"g_run_{i}": "".join(
        "G" * p if isinstance(p, int) else genome[p[0]:p[1]]
        for p in pieces).encode()
        for i, pieces in enumerate(_G_RUN_READS[case])}
    reads["plain"] = genome[12000:12400].encode()
    reads_path = str(tmp_path / "reads.fa")
    with open(reads_path, "w") as f:
        f.writelines(f">{rid}\n{rd.decode()}\n" for rid, rd in reads.items())
    ms_prefix = digested["use_promotions_ms"]["ref_file"]
    dense = tpl.load_dense_index(ms_prefix + ".bin.thrbv.ms")
    text = np.asarray(dense.text, np.uint8)
    raw = build_raw_index(text)
    native = NativeQueryEngine(raw.n, raw.run_heads, raw.run_starts,
                               raw.thresholds, raw.samples_start,
                               raw.samples_last, text=text)
    digests = _digests(reads)
    syms = list(digests.values())
    top = _last_symbol(dense)
    assert [max(d) > top for d in syms] == [True] * (len(syms) - 1) + [False]
    pml = native.query_pml(syms)
    ptrs, lens = native.query_ms(syms)

    index = build_layered(dense)
    rev, fwd, n = raw_rows(syms, 1024)
    got_pml = kernels.layered_scan_reference(index, rev, n, "pml", False)[0]
    got_ptr = kernels.layered_scan_reference(index, rev, n, "ms", False)[0]
    got_len = kernels.ms_extend_reference(index.text, index.text_bound, fwd,
                                          n, got_ptr)
    for i, m in enumerate(n.tolist()):
        assert np.array_equal(got_pml[i, :m].numpy(), pml[i]), i
        assert np.array_equal(got_ptr[i, :m].numpy(), ptrs[i]), i
        assert np.array_equal(got_len[i, :m].numpy(), lens[i]), i

    ids = list(reads)
    for prefix, kw, files in (
            (ms_prefix, dict(ms_requested=True),
             {".lengths": lens, ".pointers": ptrs}),
            (digested["use_promotions"]["ref_file"],
             dict(pml_requested=True), {".pseudo_lengths": pml})):
        _clear(reads_path)
        assert tpl.run(tpl.RunConfig(
            device="cpu", ref_file=prefix, pattern_file=reads_path,
            use_promotions=True, write_report=True, **kw)) == len(reads)
        for ext, want in files.items():
            recs = _value_records(reads_path + ext)
            assert list(recs) == ids
            for rid, w in zip(ids, want):
                assert np.array_equal(recs[rid], w), (ext, rid)
        scored = files[".lengths" if ".lengths" in files
                       else ".pseudo_lengths"]
        got, want = _report_lines(reads_path + ".report",
                                  dict(zip(ids, scored)))
        assert got == want


def test_digested_ms_run_exports_its_load_and_past_symbols(digested,
                                                           tmp_path,
                                                           monkeypatch):
    """A `run -m -M -c` under SPUMONI_TRACE exports the layered load's
    spans (`load.layered` around `load.fields` and `load.text`) and the
    counter `symbols.past_index`: the read symbols past the index's last
    (one a G run here)."""
    import json

    genome = digested["genome"]
    reads_path = str(tmp_path / "reads.fa")
    with open(reads_path, "w") as f:
        f.write(f">g_run\n{genome[100:400]}{'G' * 16}{genome[500:700]}\n"
                f">plain\n{genome[9000:9500]}\n")
    path = str(tmp_path / "trace.json")
    monkeypatch.setenv("SPUMONI_TRACE", path)
    assert tpl.run(tpl.RunConfig(
        device="cpu", ref_file=digested["use_promotions_ms"]["ref_file"],
        pattern_file=reads_path, use_promotions=True, ms_requested=True,
        write_report=True)) == 2
    with open(path) as f:
        exported = json.load(f)
    spans = {e["name"]: e for e in exported["traceEvents"] if e["ph"] == "X"}
    assert {"load.layered", "load.fields", "load.text"} <= set(spans)
    outer = spans["load.layered"]
    for name in ("load.fields", "load.text"):
        assert spans[name]["args"]["parent"] == outer["args"]["id"], name
    assert exported["otherData"]["counters"]["symbols.past_index"] == 1


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
