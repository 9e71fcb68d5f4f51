"""The benchmark's CPU tests: `python -m pytest benchmark/tests -q` from the
repository's root. `tiny` shrinks a cell to a size the CPU runs in
seconds: 3 strains of 30,000 bp, 200 reads of 300 bp (16 long reads)."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# traffic files and their configurations; ms_doc_values (-M -c -d) is no
# cell of BENCHMARK.json (PERF.md, Open questions) but its path is checked:
# pml_report's traffic with its flags
CONFIG = {"pml_report": "ecoli10_docs", "digest_report": "ecoli10_digest",
          "pml_values_long": "ecoli10_docs", "ms_doc_values": "ecoli10_docs"}
FLAGS = {"ms_doc_values": ("pml_report", ["-M", "-c", "-d", "-n"])}
CELLS = list(CONFIG)


def tiny(traffic: str):
    """(a cell of BENCHMARK.json whose chips and metrics the run takes,
    the configuration, the traffic) at a tiny size."""
    from benchmark import run

    root = os.path.join(ROOT, "benchmark")
    cfg = run.load_json(os.path.join(root, "configs",
                                     CONFIG[traffic] + ".json"))
    base, flags = FLAGS.get(traffic, (traffic, None))
    cell = run.load_json(os.path.join(root, "cells", base + ".json"))
    if flags:
        cell = dict(cell, flags=flags)
    bench = run.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    names = {w["name"] for w in bench["workloads"]}
    workload = traffic if traffic in names else "pml_values_long"
    cfg = dict(cfg, strains=3, strain_len=30000)
    if cell["length"]["kind"] == "fixed":
        cell = dict(cell, reads=200, check_reads=80,
                    length={"kind": "fixed", "bp": 300})
    else:
        cell = dict(cell, reads=16, check_reads=8,
                    length=dict(cell["length"], mean=2000, sd=1500,
                                max=8000))
    return workload, cfg, cell


@pytest.fixture
def tiny_cell():
    return tiny
