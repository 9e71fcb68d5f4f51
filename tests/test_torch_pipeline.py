"""End-to-end parity of the port's `run` (device='cpu': the plain PyTorch
versions) with the JAX package's `run` (JAX CPU backend): byte-identical
output files on the tests/test_pipeline.py fixtures and the golden corpus,
for PML (-P) and MS (-M), with and without document tracking (-d). The
layered engine's runs, digested indexes and general text are in
tests/test_torch_layered_pipeline.py.
"""

import functools
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from spumoni_tpu.pipeline import BuildConfig, RunConfig as JaxRunConfig
from spumoni_tpu.pipeline import build, run as jax_run

import spumoni_tpu_torch.pipeline as tpl
from spumoni_tpu_torch import outputs
from spumoni_tpu_torch.classify.values_writer import ValuesWriter

from test_golden import GOLDEN, _generate
from test_pipeline import _write_genome, _write_reads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def indexed(tmp_path, rng):
    genome_path = str(tmp_path / "genome.fa")
    reads_path = str(tmp_path / "reads.fa")
    seqs = _write_genome(genome_path, rng)
    _write_reads(reads_path, rng, "".join(seqs.values()))
    with open(reads_path, "a") as f:   # absent chars, a long read
        f.write(">with_n\n" + "N" * 30 + seqs["chr1"][500:900] + "XY\n")
        f.write(">long\n" + seqs["chr1"][:5000] + "\n")
    build(BuildConfig(ref_file=genome_path, output_prefix=str(tmp_path / "idx"),
                      pml_index=True, use_minimizers=False))
    return dict(ref_file=str(tmp_path / "idx"), pattern_file=reads_path,
                pml_requested=True, min_digest=False)


def _outputs(reads_path, exts):
    return {e: open(reads_path + e, "rb").read()
            for e in exts if os.path.exists(reads_path + e)}


def _both(base, exts, **kw):
    """Runs JAX then the port on the same config; returns both outputs."""
    n_jax = jax_run(JaxRunConfig(**base, **kw))
    want = _outputs(base["pattern_file"], exts)
    for e in exts:
        if os.path.exists(base["pattern_file"] + e):
            os.remove(base["pattern_file"] + e)
    n_port = tpl.run(tpl.RunConfig(device="cpu", **base, **kw))
    assert n_jax == n_port == 14
    return want, _outputs(base["pattern_file"], exts)


def test_full_run_matches_jax(indexed):
    want, got = _both(indexed, (".pseudo_lengths", ".report"),
                      write_report=True)
    assert set(want) == {".pseudo_lengths", ".report"}
    assert got == want


def test_report_only_matches_jax(indexed):
    want, got = _both(indexed, (".pseudo_lengths", ".report"),
                      write_report=True, report_only=True)
    assert set(want) == {".report"}
    assert got == want


def test_ks_report_matches_jax(indexed):
    want, got = _both(indexed, (".pseudo_lengths", ".report"),
                      write_report=True, ks_report=True)
    assert b"avg ks-stat" in want[".report"]
    assert got == want


def test_fast_start_matches_jax(indexed, monkeypatch):
    """The port serves from the rows cache the JAX run wrote, without the
    dense index, byte-identically; a touched index file invalidates it."""
    jax_run(JaxRunConfig(**indexed, write_report=True))   # writes the cache
    exts = (".pseudo_lengths", ".report")
    want = _outputs(indexed["pattern_file"], exts)
    assert os.path.exists(indexed["ref_file"]
                          + ".fa.thrbv.spumoni.bbrows.npz")

    def _poisoned(path):
        raise AssertionError("dense index loaded on fast-start path")

    monkeypatch.setattr(tpl, "load_dense_index", _poisoned)
    tpl.run(tpl.RunConfig(device="cpu", write_report=True, **indexed))
    assert _outputs(indexed["pattern_file"], exts) == want
    os.utime(indexed["ref_file"] + ".fa.thrbv.spumoni.npz")
    with pytest.raises(AssertionError, match="fast-start"):
        tpl.run(tpl.RunConfig(device="cpu", write_report=True, **indexed))


def test_resume_continues_the_files(indexed):
    """--resume after 5 durable reads appends the rest byte-identically."""
    full = tpl.run(tpl.RunConfig(device="cpu", write_report=True, **indexed))
    reads_path = indexed["pattern_file"]
    want = _outputs(reads_path, (".pseudo_lengths", ".report"))
    recs = want[".pseudo_lengths"].split(b"\n")
    with open(reads_path + ".pseudo_lengths", "wb") as f:
        f.write(b"\n".join(recs[:10]) + b"\n")
    with open(reads_path + ".report", "wb") as f:
        f.write(b"".join(want[".report"].splitlines(True)[:6]))
    with open(reads_path + ".cursor", "w") as f:
        f.write("5")
    n = tpl.run(tpl.RunConfig(device="cpu", write_report=True, resume=True,
                              **indexed))
    assert n == full
    assert _outputs(reads_path, (".pseudo_lengths", ".report")) == want


def test_golden_pml_outputs(tmp_path):
    """The PML half of the golden corpus (tests/test_golden.py)."""
    wd = _generate(str(tmp_path))
    for name in ("reads.fa.pseudo_lengths", "reads.fa.report"):
        os.remove(os.path.join(wd, name))
    tpl.run(tpl.RunConfig(ref_file=os.path.join(wd, "idx"),
                          pattern_file=os.path.join(wd, "reads.fa"),
                          pml_requested=True, min_digest=False,
                          write_report=True, device="cpu"))
    for name in ("reads.fa.pseudo_lengths", "reads.fa.report"):
        got = open(os.path.join(wd, name), "rb").read()
        assert got == open(os.path.join(GOLDEN, name), "rb").read(), name


@pytest.mark.parametrize("engine", ["bits", "layered"])
def test_golden_ms_outputs(tmp_path, engine):
    """The MS half of the golden corpus: `run -M -n` on either engine
    writes the pinned .lengths and .pointers."""
    wd = _generate(str(tmp_path))
    for name in ("reads.fa.lengths", "reads.fa.pointers"):
        os.remove(os.path.join(wd, name))
    tpl.run(tpl.RunConfig(ref_file=os.path.join(wd, "idx"),
                          pattern_file=os.path.join(wd, "reads.fa"),
                          ms_requested=True, min_digest=False, engine=engine,
                          device="cpu"))
    for name in ("reads.fa.lengths", "reads.fa.pointers"):
        got = open(os.path.join(wd, name), "rb").read()
        assert got == open(os.path.join(GOLDEN, name), "rb").read(), name


@pytest.fixture(scope="module")
def msdoc(tmp_path_factory):
    """A three-document index built with -M -P -d from a file list, and
    reads with N, bytes absent from the index, reads running off a
    document's and the text's end, and a read spanning two documents."""
    tmp = tmp_path_factory.mktemp("msdoc")
    rng = np.random.default_rng(17)
    docs, listing = [], []
    for d in range(3):
        path = str(tmp / f"doc{d}.fa")
        seqs = _write_genome(path, rng, contigs=((f"seq{d}", 3000 + 700 * d),))
        docs.append("".join(seqs.values()))
        listing.append(f"{path} {d + 1}\n")
    with open(tmp / "files.txt", "w") as f:
        f.writelines(listing)
    reads_path = str(tmp / "reads.fa")
    genome = "".join(docs)
    _write_reads(reads_path, rng, genome, n_pos=5, n_neg=4, m=300)
    with open(reads_path, "a") as f:
        f.write(">with_n\n" + "N" * 30 + docs[0][500:800] + "NXY\n")
        f.write(">doc_end\n" + docs[1][-250:] + docs[2][:40] + "\n")
        f.write(">text_end\n" + docs[2][-200:] + "ACGTA\n")
        f.write(">long\n" + (docs[0] + docs[1])[2000:3300] + "\n")
    build(BuildConfig(input_list=str(tmp / "files.txt"),
                      output_prefix=str(tmp / "idx"), ms_index=True,
                      pml_index=True, build_doc=True, use_minimizers=False))
    return dict(ref_file=str(tmp / "idx"), pattern_file=reads_path,
                min_digest=False)


_VALUE_EXTS = (".pointers", ".lengths", ".pseudo_lengths", ".doc_numbers",
               ".report")


def _clear(reads_path):
    for e in _VALUE_EXTS:
        if os.path.exists(reads_path + e):
            os.remove(reads_path + e)


_MSDOC_RUNS = {
    "M-c": dict(ms_requested=True, write_report=True),
    "M-c-report-only": dict(ms_requested=True, write_report=True,
                            report_only=True),
    "M-d": dict(ms_requested=True, use_doc=True),
    "M-d-c": dict(ms_requested=True, use_doc=True, write_report=True),
    "P-d-c": dict(pml_requested=True, use_doc=True, write_report=True),
    "M-c-ks-report": dict(ms_requested=True, write_report=True,
                          ks_report=True),
    # three reads a batch (--resume after 4 lands inside the second), and
    # the value files' pass through a 64-byte buffer: records straddle its
    # chunks and calls
    "M-d-c-batches": dict(ms_requested=True, use_doc=True, write_report=True,
                          batch_bases=700, value_chunk=64),
    "P-c-batches": dict(pml_requested=True, write_report=True,
                        batch_bases=700, value_chunk=64),
    "P-c-ks-report-batches": dict(pml_requested=True, write_report=True,
                                  ks_report=True, batch_bases=700,
                                  value_chunk=64),
}


def _msdoc_run(monkeypatch, run_id):
    """The run's RunConfig fields; a `value_chunk` sets the port's value
    buffer."""
    kw = dict(_MSDOC_RUNS[run_id])
    chunk = kw.pop("value_chunk", None)
    if chunk:
        monkeypatch.setattr(outputs, "ValuesWriter",
                            functools.partial(ValuesWriter, chunk))
    return kw


@pytest.mark.parametrize("run_id", sorted(_MSDOC_RUNS))
def test_ms_and_doc_runs_match_jax(msdoc, run_id, monkeypatch):
    """-M and -d runs write the files the JAX package's block-bits engine
    writes, byte for byte."""
    kw = _msdoc_run(monkeypatch, run_id)
    reads_path = msdoc["pattern_file"]
    _clear(reads_path)
    n_jax = jax_run(JaxRunConfig(**msdoc, engine="bits", **kw))
    want = _outputs(reads_path, _VALUE_EXTS)
    _clear(reads_path)
    n_port = tpl.run(tpl.RunConfig(device="cpu", **msdoc, **kw))
    assert n_jax == n_port == 13
    expect = {".report"} if kw.get("write_report") else set()
    if not kw.get("report_only"):
        expect |= ({".pointers", ".lengths"} if kw.get("ms_requested")
                   else {".pseudo_lengths"})
        expect |= {".doc_numbers"} if kw.get("use_doc") else set()
    assert set(want) == expect
    assert _outputs(reads_path, _VALUE_EXTS) == want


@pytest.mark.parametrize("run_id", sorted(_MSDOC_RUNS))
def test_ms_doc_resume_continues_the_files(msdoc, run_id, monkeypatch):
    """--resume after 4 durable reads appends the rest of every file
    byte-identically to the JAX package's uninterrupted run (with
    --ks-report, the rand() draws owed for the skipped reads included)."""
    reads_path = msdoc["pattern_file"]
    kw = _msdoc_run(monkeypatch, run_id)
    _clear(reads_path)
    full = jax_run(JaxRunConfig(**msdoc, engine="bits", **kw))
    want = _outputs(reads_path, _VALUE_EXTS)
    assert want
    for e, data in want.items():
        keep = 5 if e == ".report" else 8      # header + 4 lines / records
        with open(reads_path + e, "wb") as f:
            f.write(b"".join(data.splitlines(True)[:keep]))
    with open(reads_path + ".cursor", "w") as f:
        f.write("4")
    n = tpl.run(tpl.RunConfig(device="cpu", resume=True, **msdoc, **kw))
    assert n == full == 13
    assert _outputs(reads_path, _VALUE_EXTS) == want


def test_cli_runs_without_jax(tmp_path, rng):
    """`python -m spumoni_tpu_torch build` and `run --device cpu` finish
    with neither jax nor spumoni_tpu imported (-X importtime lists every
    module the process imported)."""
    genome_path = str(tmp_path / "g.fa")
    seqs = _write_genome(genome_path, rng, contigs=(("chr1", 6000),))
    reads_path = str(tmp_path / "r.fa")
    _write_reads(reads_path, rng, seqs["chr1"], n_pos=2, n_neg=2, m=200)
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("JAX_PLATFORMS", None)
    for args in (["build", "-r", genome_path, "-P", "-n", "-o",
                  str(tmp_path / "i")],
                 ["run", "-r", str(tmp_path / "i"), "-p", reads_path, "-P",
                  "-n", "-c", "--device", "cpu"]):
        res = subprocess.run(
            [sys.executable, "-X", "importtime", "-m", "spumoni_tpu_torch",
             *args], cwd=str(tmp_path), env=env, capture_output=True,
            text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-2000:]
        mods = {ln.rsplit("|", 1)[1].strip() for ln in res.stderr.splitlines()
                if ln.startswith("import time:") and "|" in ln}
        assert "spumoni_tpu_torch.pipeline" in mods or args[0] == "build"
        leaked = {m for m in mods if m.split(".")[0] in ("jax", "jaxlib",
                                                         "spumoni_tpu")}
        assert not leaked, leaked
    assert os.path.getsize(reads_path + ".report") > 0


_LOAD_CHECK = """
import ast, os, sys
repo = sys.argv[1]
sys.path.insert(0, repo)
from spumoni_tpu_torch import cli
cli.main(sys.argv[2].split())
cli.main(sys.argv[3].split())
with open(os.path.join(repo, "chip_smoke.py")) as f:
    tree = ast.parse(f.read())
for node in ast.walk(tree):   # every import chip_smoke.py makes, nested too
    if isinstance(node, ast.Import) or isinstance(node, ast.ImportFrom) \\
            and not node.level:
        exec(ast.unparse(node))
import chip_smoke
jax_pkg = os.path.join(repo, "spumoni_tpu") + os.sep
print("LOADED", sorted(
    name for name, mod in list(sys.modules.items())
    if name.startswith(("jax", "_spumoni_tpu_host"))
    or name.split(".")[0] == "spumoni_tpu"
    or os.path.realpath(getattr(mod, "__file__", None) or "").startswith(
        jax_pkg)))
"""


def test_port_loads_nothing_from_the_jax_package(tmp_path, rng):
    """One process runs the port's CLI `build` and `run --device cpu`, then
    every import of chip_smoke.py: afterwards no module is named jax*,
    spumoni_tpu or _spumoni_tpu_host*, and no module was loaded from a file
    under spumoni_tpu/, whatever its name."""
    genome_path = str(tmp_path / "g.fa")
    seqs = _write_genome(genome_path, rng, contigs=(("chr1", 6000),))
    reads_path = str(tmp_path / "r.fa")
    _write_reads(reads_path, rng, seqs["chr1"], n_pos=2, n_neg=2, m=200)
    env = {**os.environ, "PYTHONPATH": REPO}
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-c", _LOAD_CHECK, REPO,
         f"build -r {genome_path} -P -n -o {tmp_path / 'i'}",
         f"run -r {tmp_path / 'i'} -p {reads_path} -P -n -c --device cpu"],
        cwd=str(tmp_path), env=env, capture_output=True, text=True,
        timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.splitlines()[-1] == "LOADED []"
    assert os.path.getsize(reads_path + ".report") > 0


#: an import of the JAX package or of the old loader, as a statement
_JAX_PACKAGE_IMPORT = re.compile(
    r"_spumoni_tpu_host|^\s*import spumoni_tpu\b|^\s*from spumoni_tpu[.\s]",
    re.M)


def test_port_sources_import_nothing_of_the_jax_package():
    """No source of the port and no line of chip_smoke.py names the old
    loader or imports spumoni_tpu (comments citing its files are fine)."""
    paths = [os.path.join(REPO, "chip_smoke.py")] + [
        p for ext in ("py", "cu", "cuh") for p in glob.glob(
            os.path.join(REPO, "spumoni_tpu_torch", "**", f"*.{ext}"),
            recursive=True)]
    assert len(paths) > 25
    hits = {}
    for path in paths:
        with open(path) as f:
            found = _JAX_PACKAGE_IMPORT.findall(f.read())
        if found:
            hits[os.path.relpath(path, REPO)] = found
    assert not hits
