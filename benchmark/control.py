"""The control of a cell's comparison: the reference put in the program's
place with one guarantee of the configuration broken, judged as a run's
files are judged. It must come out as not correct.

    python3 benchmark/control.py --workload <cell> --seed <n> [--seed <n> ...]

The broken guarantee: MONI's thresholds sit at the leftmost minimum of the
LCP array between two runs of a symbol; the control takes the rightmost,
so a walk at a tie moves up where SPUMONI moves down. The benchmark's own
runs never run this. Seeds run in parallel processes, one a seed, each
printing its numbers beside their limits; the suffix arrays are sorted on
the card where there is one.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys

import torch

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from benchmark import run, traffic  # noqa: E402
from benchmark.reference.deployment import Deployment  # noqa: E402


def control_checks(workload: str, seed: int, config=None, cell=None) -> dict:
    """The numbers the control's outputs give, each {value, limit}."""
    _, _, cfg0, cell0 = run.cell_spec(workload)
    config = config or cfg0
    cell = cell or cell0
    flags = list(cell["flags"])
    strains = traffic.pangenome(config, seed)
    ids, seqs = traffic.reads(cell, strains, seed)
    dep = Deployment(strains, config["build"],
                     "cuda" if torch.cuda.is_available() else "cpu")
    picks = run.sample_reads(ids, seqs, int(cell["check_reads"]), seed)
    exp = run.expected(dep, cell, ids, seqs, picks, flags)
    ctl = run.expected(dep, cell, ids, seqs, picks, flags, down_on_tie=False)
    got = {}
    if "-c" in flags:
        got["report"] = (ctl["header"], dict(ctl["lines"]))
    for rid, rec in ctl["values"].items():
        if "--report-only" in flags:
            break
        for k, v in rec.items():
            line = " ".join(str(int(x)) for x in v).encode()
            got.setdefault(k, {})[rid] = line
    return run.compare(exp, got, flags, len(picks))


def _one(args):
    workload, seed = args
    return seed, control_checks(workload, seed)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, action="append", required=True)
    args = ap.parse_args(argv)
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(len(args.seed)) as pool:
        for seed, checks in pool.imap(_one, [(args.workload, s)
                                             for s in args.seed]):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "checks": checks}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
