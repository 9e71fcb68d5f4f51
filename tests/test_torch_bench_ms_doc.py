"""The port against the benchmark's plain reference (benchmark/reference/)
on the `ms_doc_values` cell's traffic file (`run -M -c -d -n`), on the CPU
at a tiny size, on its `ecoli10_ms_docs` index (`build -M -d -n`, no PML
index): 3 strains of 30,000 bp, 16 reads of gamma lengths (mean
2,000, sd 1,500, at most 8,000 bp), 8 of them checked with the longest.

The run goes in a fresh interpreter: the harness refuses a run with JAX or
the JAX package loaded, and this suite's conftest loads both."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RUN = """
import json, sys
sys.path.insert(0, {root!r})
from benchmark import run

_, _, cfg, cell = run.cell_spec("ms_doc_values")
cfg = dict(cfg, strains=3, strain_len=30000)
cell = dict(cell, reads=16, check_reads=8,
            length=dict(cell["length"], mean=2000, sd=1500, max=8000))
res = run.run_cell("ms_doc_values", {seed}, 1.0, False, device="cpu",
                   config=cfg, cell=cell, work={work!r})
print(json.dumps(res))
"""


def test_ms_doc_values_matches_the_reference(tmp_path):
    sys.path.insert(0, ROOT)
    try:
        from benchmark import run
    finally:
        sys.path.remove(ROOT)
    _, wl, cfg, cell = run.cell_spec("ms_doc_values", ROOT)
    assert (wl["config"], cfg["build"]) == ("ecoli10_ms_docs", "docs")
    assert cfg["build_flags"] == ["-M", "-d", "-n"]
    assert cell["flags"] == ["-M", "-c", "-d", "-n"]
    assert run.reference_imports(ROOT) == []
    code = RUN.format(root=ROOT, seed=2**33 + 41, work=str(tmp_path / "w"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    checks = res["checks"]
    assert res["correct"], checks
    assert {"report_lines_wrong", "value_records_wrong", "records_missing",
            "calls_differing"} <= set(checks)
    assert all(c["value"] == 0 for c in checks.values()), checks
    assert res["attempted"] >= 16 and res["failed"] == 0
    assert res["metrics"]["values_mbp_s"]["value"] > 0


def test_ms_docs_index_is_the_docs_index_without_pml(tmp_path):
    """`ecoli10_ms_docs` (`build -M -d -n`) writes every file a `-M -d` run
    reads byte for byte as `ecoli10_docs` (`-M -P -d -n`) does, and none
    of the PML index's: the two cells on them differ in the query alone."""
    import hashlib

    sys.path.insert(0, ROOT)
    try:
        from benchmark import run, traffic
    finally:
        sys.path.remove(ROOT)
    from spumoni_tpu_torch import cli

    _, _, ms_cfg, _ = run.cell_spec("ms_doc_values", ROOT)
    _, _, docs_cfg, _ = run.cell_spec("pml_values_long", ROOT)
    strains = traffic.pangenome(dict(ms_cfg, strains=3, strain_len=20000),
                                2**33 + 7)
    files = {}
    for cfg in (docs_cfg, ms_cfg):
        work = tmp_path / cfg["name"]
        work.mkdir()
        inputs = traffic.write_pangenome(str(work), strains, cfg["build"])
        cli.main(["build", "-i", inputs["list"], *cfg["build_flags"],
                  "-o", str(work / "index")])
        files[cfg["name"]] = {
            p.name: hashlib.sha256(p.read_bytes()).hexdigest()
            for p in work.iterdir() if p.name.startswith("index")}
    docs, ms = files["ecoli10_docs"], files["ecoli10_ms_docs"]
    assert {"index.fa.thrbv.ms.npz", "index.fa.msnulldb.npz",
            "index.fa.doc.npz"} <= set(ms)
    assert {f: docs[f] for f in ms} == ms
    pml = {f for f in docs if "spumoni" in f or "pml" in f}
    assert pml and not pml & set(ms)
    assert set(docs) - set(ms) == pml
