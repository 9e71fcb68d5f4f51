"""Times K3 `ms_scan` and K15 `ms_scan_tp` at the lane counts the runs
launch, beside the design they replace and K1 / K2 as controls.

    python -m spumoni_tpu_torch.scripts.time_ms_scan --parent DIR \
        [--ablate] [--shapes 8192,32768,65536] [--out DIR]

Run from the repository root on a machine with one NVIDIA GPU. It writes
chip_smoke.py's inputs (10 strains, 65,536 reads of 1,024 bp) into
chip_smoke_work/, builds phase 4b's MS + doc index (`build -i list -M -P
-d -n`) and stages the reads once; a launch at B lanes takes the first B
of them (value runs launch 8,192, report-only runs 32,768, chip_smoke.py's
tables 65,536). Per shape, CUDA-event ms per call (a warm-up, then 5
calls) of:

  * K1 `pml_scan` and K2 `pml_classify` on the same index's PML rows,
    whose source this comparison does not change (the controls of two
    calls);
  * K3 in each mode (ms, ms+doc, pml+doc) and K15 on 4 shards (ms,
    ms+doc), each in turns with the same entry points built from DIR's
    `spumoni_tpu_torch/csrc` (the parent: parent, current, parent),
    outputs equal (max |err| 0);
  * with --ablate, timing-only variants of the parent's K3 / K15, built
    from patched copies of its sources (`ABLATIONS`): (a) the jump-table
    reads replaced by the jump id, (b) both in-block rank loops cut to
    one word, (c) both, (d) 32-thread blocks. They may give wrong
    answers and are never used for anything else. The patches are
    literal lines of the one-thread-a-read design (commit dfdde28): on
    any other parent --ablate stops with the line it did not find.

DIR holds the parent's `spumoni_tpu_torch/csrc` and
`spumoni_tpu_torch/engine/kernels.py`: the script reads the parent's
entry points from the latter's `_SIGNATURES` and stops unless they are
this tree's (it calls both through this tree's argument lists). Also
writes the SASS of the ms+doc instance (P = 512, pack = 2, not wide) of
the current K3 and of the parent's to the --out directory, and prints
ptxas' registers and spills for it. Everything goes to --out (JSON); the
card's name and power limit head the output. PERF.md section 6's K3 /
K15 redesign numbers come from this script: the baseline and ablations
(`--parent` = dfdde28, `--ablate`), then the redesign against it.
"""

from __future__ import annotations

import argparse
import ast
import ctypes
import json
import os
import subprocess
import sys
import time

import torch

from ..engine import kernels
from ..parallel import tp

MODES = {"ms": ("ms", False, 0), "ms+doc": ("ms", True, 1),
         "pml+doc": ("pml", True, 2)}
TP_MODES = ("ms", "ms+doc")
SHARDS = 4
#: the instances whose SASS and ptxas report are kept (P = 512, pack = 2,
#: not wide): dfdde28's ms+doc (its last template argument the mode) and
#: the current design (the mode a runtime argument)
SASS_KEYS = {"parent": ("ms_scan_kernelILi512ELi2ELb0ELi1E",),
             "current": ("ms_scan_kernelILi512ELi2ELb0EE",)}
#: the entry points the script calls, through this tree's argument lists
ENTRY_POINTS = ("spn_ms_scan", "spn_ms_scan_tp")

#: timing-only variants of the parent's sources: label -> [(file, text,
#: replacement)]; every text must occur in the parent's file
_NO_JUMPS = [
    ("blockbits_ms.cu", "ov[-t] = (PosT)(jump_t[jidx] - (PosT)run);",
     "ov[-t] = (PosT)(jidx - (PosT)run);"),
    ("blockbits_ms.cu", "if (MODE != kMs) od[-t] = (PosT)jump_d[jidx];",
     "if (MODE != kMs) od[-t] = (PosT)jidx;"),
    ("blockbits_ms.cu", "ov[-t] = (PosT)(*jump_t.row(jidx, 1) - (PosT)run);",
     "ov[-t] = (PosT)(jidx - (PosT)run);"),
    ("blockbits_ms.cu", "if (MODE != kMs) od[-t] = (PosT)*jump_d.row(jidx, 1);",
     "if (MODE != kMs) od[-t] = (PosT)jidx;")]
_ONE_WORD = [
    ("blockbits_ms.cu", "for (int w = 0; w < wcut; ++w)",
     "for (int w = 0; w < (wcut < 1 ? wcut : 1); ++w)"),
    ("blockbits_pml.cuh", "for (int w = 0; w < wsel; ++w)",
     "for (int w = 0; w < (wsel < 1 ? wsel : 1); ++w)")]
ABLATIONS = {
    "a-no-jump-reads": _NO_JUMPS,
    "b-one-word-ranks": _ONE_WORD,
    "c-both": _NO_JUMPS + _ONE_WORD,
    "d-32-thread-blocks": [("blockbits_ms.cu", "constexpr int kThreads = 128;",
                            "constexpr int kThreads = 32;")]}


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def parent_signatures(parent: str) -> dict:
    """ENTRY_POINTS' argument types as DIR's kernels.py declares them
    (`_SIGNATURES["blockbits_ms"]`); fails unless they are this tree's."""
    path = os.path.join(parent, "spumoni_tpu_torch", "engine", "kernels.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    node = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                and any(getattr(t, "id", None) == "_SIGNATURES"
                        for t in n.targets))
    node = next(v for k, v in zip(node.keys, node.values)
                if getattr(k, "value", None) == "blockbits_ms")
    # its ctypes names (_P, _I32, ...) as this tree's kernels.py binds them
    sigs = eval(compile(ast.Expression(node), path, "eval"),
                dict(vars(kernels)))
    ours = kernels._SIGNATURES["blockbits_ms"]
    for fn in ENTRY_POINTS:
        if sigs[fn] != ours[fn]:
            raise SystemExit(f"time_ms_scan: the parent's {fn} takes other "
                             f"arguments than this tree's; this script "
                             f"calls it through this tree's")
    return {fn: ours[fn] for fn in ENTRY_POINTS}


def build_variants(parent_csrc: str, labels, signatures) -> dict:
    """nvcc of blockbits_ms.cu from a copy of parent_csrc per label (with
    ABLATIONS[label] applied; 'parent' unpatched), all at once, into
    kernels.BUILD_DIR/lab-<label>/. Returns {label: (library, ptxas log)}."""
    procs = {}
    for label in labels:
        d = os.path.join(kernels.BUILD_DIR, f"lab-{label}")
        os.makedirs(d, exist_ok=True)
        for name in os.listdir(parent_csrc):
            with open(os.path.join(parent_csrc, name)) as f:
                src = f.read()
            for fname, old, new in ABLATIONS.get(label, ()):
                if fname == name:
                    if old not in src:
                        raise RuntimeError(
                            f"{label}: {old!r} not in {name} (the ablations "
                            f"patch dfdde28's sources)")
                    src = src.replace(old, new)
            with open(os.path.join(d, name), "w") as f:
                f.write(src)
        so = os.path.join(d, "libblockbits_ms.so")
        procs[label] = (so, subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-o", so,
             os.path.join(d, "blockbits_ms.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {label}:\n{log}")
        lib = ctypes.CDLL(so)
        for fn, argtypes in signatures.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        libs[label] = (lib, so, log)
    return libs


def parent_call(lib, index, tab, rev, lens, label):
    """The parent's K3 (a BlockBitsIndex) or K15 (a ShardedBlockBits)
    through its own entry point, with its wrapper's allocation."""
    mode, use_doc, code = MODES[label]
    m = index.meta
    dev = rev.device
    vals = torch.zeros(rev.shape, dtype=m.pos_dtype, device=dev)
    docs = torch.zeros_like(vals) if use_doc else None
    ptr = lambda t: 0 if t is None else t.data_ptr()   # noqa: E731
    stream = torch.cuda.current_stream(dev).cuda_stream
    if isinstance(index, tp.ShardedBlockBits):
        sp = lambda t: None if t is None else kernels._shard_ptrs(t)  # noqa
        rows = index.bblocks
        jumps = index.jump_t if index.jump_t is not None else index.jump_d
        rc = lib.spn_ms_scan_tp(
            sp(rows), sp(index.msrows), rows.S, rows.rows_per_shard,
            rows.shape[0], m.P, m.pack, int(m.wide), m.n, m.term_pos,
            m.F_term, m.term_code, m.r, m.term_runidx, tab.data_ptr(),
            tab.shape[0], rev.data_ptr(), lens.data_ptr(), rev.shape[0],
            rev.shape[1], sp(index.jump_t), sp(index.jump_d),
            jumps.rows_per_shard, code, vals.data_ptr(), ptr(docs), stream)
    else:
        rc = lib.spn_ms_scan(
            index.bblocks.data_ptr(), index.msrows.data_ptr(),
            index.bblocks.shape[0], m.P, m.pack, int(m.wide), m.n,
            m.term_pos, m.F_term, m.term_code, m.r, m.term_runidx,
            tab.data_ptr(), tab.shape[0], rev.data_ptr(), lens.data_ptr(),
            rev.shape[0], rev.shape[1], ptr(index.jump_t), ptr(index.jump_d),
            code, vals.data_ptr(), ptr(docs), stream)
    if rc:
        raise RuntimeError(f"parent entry point returned {rc}")
    return vals, docs


def _time(fn, reps=5):
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        out = fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def _err(got, want) -> int:
    return max(int((g.long() - w.long()).abs().max())
               for g, w in zip(got, want) if g is not None)


def sass_of(so: str, key: str) -> str:
    """The SASS of the one kernel of `so` whose name holds `key`."""
    cuobjdump = os.path.join(os.path.dirname(kernels._nvcc()), "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", so], check=True,
                         capture_output=True, text=True).stdout
    funcs = out.split("\t\tFunction : ")
    hits = [f for f in funcs[1:] if key in f.splitlines()[0]]
    return hits[0] if hits else ""


def ptxas_of(log: str, key: str) -> list:
    """ptxas -v's lines (properties, registers) for the kernels whose name
    holds `key`."""
    lines = log.splitlines()
    keep = []
    for i, ln in enumerate(lines):
        if "Compiling entry function" in ln and key in ln:
            keep += [ln.strip()] + [x.strip() for x in lines[i + 1:i + 4]
                                    if "Compiling entry" not in x]
    return keep


def summarize_sass(sass: str) -> dict:
    """Counts of global loads / stores / shuffles / branches in the SASS."""
    ops = []
    for ln in sass.splitlines():
        parts = ln.split("*/")
        if len(parts) > 1 and parts[1].strip().rstrip(" ;"):
            op = parts[1].strip()
            ops.append(op.split(" ", 1)[1] if op.startswith("@") else op)
    count = lambda p: sum(1 for o in ops if o.startswith(p))  # noqa: E731
    return dict(instructions=len(ops), ldg=count("LDG"), stg=count("STG"),
                shfl=count("SHFL"), bra=count("BRA"), lds=count("LDS"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="a source tree of the design to compare with (its "
                         "spumoni_tpu_torch/csrc)")
    ap.add_argument("--ablate", action="store_true",
                    help="also time the parent's ABLATIONS")
    ap.add_argument("--shapes", default="8192,32768,65536")
    ap.add_argument("--out", default="ms_scan_timing")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_ms_scan: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from .. import cli

    smi = _smi()
    print(f"{smi}; torch {torch.__version__} (CUDA {torch.version.cuda})",
          flush=True)
    os.makedirs(args.out, exist_ok=True)
    dev = torch.device("cuda", 0)
    shapes = [int(x) for x in args.shapes.split(",")]
    t0 = time.time()
    kernels.build()
    labels = ["parent"] + (list(ABLATIONS) if args.ablate else [])
    libs = build_variants(os.path.join(args.parent, "spumoni_tpu_torch",
                                       "csrc"), labels,
                          parent_signatures(args.parent))
    print(f"kernels built in {time.time() - t0:.1f} s", flush=True)
    report = dict(device=smi, torch=torch.__version__, shapes=shapes)
    for label, (_, so, log) in (
            ("current", (None, kernels.build()["blockbits_ms"],
                         kernels.build_log)),
            ("parent", libs["parent"])):
        for key in SASS_KEYS[label]:
            sass = sass_of(so, key)
            with open(os.path.join(args.out, f"{label}_{key}.sass"),
                      "w") as f:
                f.write(sass)
            ptx = ptxas_of(log, key) + ptxas_of(log, key.replace(
                "ms_scan_kernel", "ms_scan_tp_kernel"))
            report[f"sass_{label}_{key}"] = dict(summarize_sass(sass),
                                                 ptxas=ptx)
            print(f"{label} {key}: {report[f'sass_{label}_{key}']}",
                  flush=True)

    t0 = time.time()
    cs.write_inputs(10)
    cli.main(cs._build_args()["-M -P -d"])
    print(f"inputs and MS index in {time.time() - t0:.1f} s", flush=True)
    reads = os.path.join(cs.WORK, "reads.fa")
    ms_prefix = os.path.join(cs.WORK, "msidx")
    engine = cs._engine(ms_prefix + ".fa.thrbv.ms", dev, "ms", use_doc=True)
    g = cs._staged(engine, reads, max(shapes))
    pml = cs._engine(ms_prefix + ".fa.thrbv.spumoni", dev)
    gp = cs._staged(pml, reads, max(shapes))
    index = engine.index
    sharded = tp.shard_blockbits_ms(index, SHARDS)
    results = []

    def row(kernel, label, B, variant, ms, err=None, **kw):
        r = dict(kernel=kernel, mode=label, B=B, variant=variant, ms=ms,
                 max_abs_err=err, **kw)
        results.append(r)
        print(json.dumps(r), flush=True)

    for B in shapes:
        tab, rev, lens = g["tab"], g["rev_d"][:B].contiguous(), \
            g["lens_d"][:B].contiguous()
        ptab, prev, plens = gp["tab"], gp["rev_d"][:B].contiguous(), \
            gp["lens_d"][:B].contiguous()
        row("pml_scan", "pml", B, "current", _time(
            lambda: kernels.pml_scan(pml.index, ptab, prev, plens))[0])
        row("pml_classify", "pml", B, "current", _time(
            lambda: kernels.pml_classify(pml.index, ptab, prev, plens, 7,
                                         cs.BIN_WIDTH))[0])
        for kernel, idx, wrapper, modes in (
                ("ms_scan", index, kernels.ms_scan, MODES),
                ("ms_scan_tp", sharded, kernels.ms_scan_tp, TP_MODES)):
            for label in modes:
                mode, use_doc, _ = MODES[label]
                lib = libs["parent"][0]
                p1, want = _time(lambda: parent_call(lib, idx, tab, rev,
                                                     lens, label))
                ms, got = _time(lambda: wrapper(idx, tab, rev, lens, mode,
                                                use_doc))
                err = _err(got, want)
                p2 = _time(lambda: parent_call(lib, idx, tab, rev, lens,
                                               label))[0]
                row(kernel, label, B, "parent", (p1 + p2) / 2, 0,
                    turns=[p1, p2])
                if err:
                    raise AssertionError(f"{kernel} {label} B={B}: != "
                                         f"parent (max |err| {err})")
                row(kernel, label, B, "current", ms, err,
                    group=kernels.MS_GROUP)
                for v in labels[1:]:
                    vlib = libs[v][0]
                    ms, got = _time(lambda: parent_call(vlib, idx, tab, rev,
                                                        lens, label))
                    row(kernel, label, B, v, ms, _err(got, want))
    report["results"] = results
    with open(os.path.join(args.out, "results.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"{smi}\ntime_ms_scan: done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
