"""Times the streaming CLI runs of chip_smoke.py's phases 4 and 4b with this
tree's package and with another tree's, in turns on one card.

    python -m spumoni_tpu_torch.scripts.time_runs --parent DIR \
        [--turns 1] [--out DIR]

Run from the repository root on a machine with one NVIDIA GPU. DIR holds
another checkout's `spumoni_tpu_torch/` and `native/` (`git archive
<commit> spumoni_tpu_torch native | tar -x -C DIR`). The script writes chip_smoke.py's
inputs (10 strains, 65,536 reads of 1,024 bp) into chip_smoke_work/ and
builds phase 4's `-P -n` and 4b's `-M -P -d -n` indexes with this tree's
CLI (the two trees build the same files). Then `--turns` times it runs
parent, current, current, parent: one process per tree and turn, which
builds that tree's kernels first and then runs RUNS through that tree's
`cli.main`, each run `repeat` times. It prints every run's streaming
seconds and reads/s (pipeline.LAST_RUN_STATS: file parse to the last
output line, index load excluded), and at the end each run's median
reads/s for each tree and their ratio, with the card's name and power
limit. With --out, the lines also go to DIR/time_runs.log.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

#: (label, index of chip_smoke_work/, flags, repeat): phase 4's and 4b's
#: runs; the report-only runs stream in under a second, so they repeat
RUNS = (("P-c", "idx", ["-P", "-c"], 1),
        ("P-c-report-only", "idx", ["-P", "-c", "--report-only"], 5),
        ("M-c-report-only", "msidx", ["-M", "-c", "--report-only"], 5),
        ("M-c-d", "msidx", ["-M", "-c", "-d"], 1),
        ("P-d-c", "msidx", ["-P", "-d", "-c"], 1))

_WORKER = r"""
import json, os, sys
sys.path.insert(0, sys.argv[1])
import torch
from spumoni_tpu_torch import cli, native, pipeline
from spumoni_tpu_torch.engine import kernels
assert os.path.dirname(kernels.__file__).startswith(sys.argv[1])
if torch.cuda.is_available():
    kernels.build()
native.get_lib()
for label, argv in json.loads(sys.argv[2]):
    cli.main(argv)
    st = pipeline.LAST_RUN_STATS
    print("RUN " + json.dumps({"label": label, "reads": st["reads"],
                               "stream_s": st["stream_s"]}), flush=True)
"""


def _smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"


def _turn(tree: str, work: str, reads: str) -> list:
    """One process on `tree`'s package: every run of RUNS, each `repeat`
    times; returns [(label, reads, stream seconds)]."""
    runs = [(label, ["run", "-r", os.path.join(work, idx), "-p", reads,
                     "-n", *flags])
            for label, idx, flags, repeat in RUNS for _ in range(repeat)]
    proc = subprocess.run([sys.executable, "-c", _WORKER, tree,
                           json.dumps(runs)], capture_output=True,
                          text=True, timeout=1200)
    if proc.returncode:
        raise RuntimeError(f"worker on {tree} failed (rc "
                           f"{proc.returncode}):\n{proc.stderr[-3000:]}")
    out = []
    for line in proc.stdout.splitlines():
        if line.startswith("RUN "):
            r = json.loads(line[4:])
            out.append((r["label"], r["reads"], r["stream_s"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a directory holding another tree's "
                         "spumoni_tpu_torch/ and native/")
    ap.add_argument("--turns", type=int, default=1,
                    help="rounds of parent, current, current, parent "
                         "(default 1)")
    ap.add_argument("--out", help="also write the lines to OUT/"
                                  "time_runs.log")
    args = ap.parse_args(argv)
    repo = os.getcwd()
    parent = os.path.abspath(args.parent)
    for need in ("spumoni_tpu_torch", "native"):
        if not os.path.isdir(os.path.join(parent, need)):
            raise SystemExit(f"{parent} holds no {need}/")
    sys.path.insert(0, repo)
    import chip_smoke as cs
    from spumoni_tpu_torch import cli

    lines = []

    def say(text):
        print(text, flush=True)
        lines.append(text)

    smi = _smi()
    say(f"card: {smi}")
    t0 = time.time()
    _, reads = cs.write_inputs(10)
    for key in ("-P -n", "-M -P -d"):
        cli.main(cs._build_args()[key])
    say(f"inputs and index builds: {time.time() - t0:.1f} s")
    order = [("parent", parent), ("current", repo), ("current", repo),
             ("parent", parent)] * args.turns
    rates = {}
    for k, (name, tree) in enumerate(order):
        for label, n, secs in _turn(tree, cs.WORK, reads):
            rates.setdefault((label, name), []).append(n / secs)
            say(f"turn {k} {name}: {label}: {n} reads in {secs:.4f} s "
                f"streaming -> {n / secs:.1f} reads/s")
    say(f"medians over {args.turns * 2} processes a tree ({smi}):")
    for label, *_ in RUNS:
        p = statistics.median(rates[label, "parent"])
        c = statistics.median(rates[label, "current"])
        say(f"  {label}: parent {p:.1f} reads/s, current {c:.1f} reads/s, "
            f"current / parent {c / p:.4f}")
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "time_runs.log"), "w") as f:
            f.write("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
