"""One run of one benchmark cell of spumoni_tpu_torch on one NVIDIA GPU.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`: a configuration
(`configs/<config>.json`: the pangenome and how it is built) and a traffic
mix (`cells/<traffic>.json`: the reads of a call and the `run` flags). Every
metric is read by `metrics/<name>.py`. All are found by name.

Set-up (counted in `setup_s`, from process start): the strains from the
seed, the port's `build` of them, the reads from the seed, and one whole
`run` call on them (kernel builds, row caches, every shape the window uses).
The window: `spumoni_tpu_torch.cli.main(["run", ...])` on the same read file,
back to back in this process, until `--seconds` have passed; the call under
way then completes. Each call loads the index as the CLI does. A CLI user
also pays process start and the CUDA context once a file; here they are in
set-up. With `--trace 1` the program's layers are wrapped (trace.py) and the
window runs under torch.profiler.

After the window: the reference (reference/, plain NumPy; its suffix array
in plain PyTorch on the card) works out the index, the null threshold and the outputs of reads sampled from the seed,
and the last call's files are compared with it; every other call's report
must equal the last call's (their value files are deleted as the window
goes, before they reach the disk). Each number compared is printed beside its limit
on standard error and under `checks`, the last key of the result line.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import ast  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
if sys.path and os.path.abspath(sys.path[0]) == HERE:
    sys.path[0] = ROOT
elif ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import traffic  # noqa: E402
from benchmark.reference.deployment import (Deployment,  # noqa: E402
                                            report_header, report_line)

FORBIDDEN = {"jax", "jaxlib", "flax", "spumoni_tpu"}
PROGRAM = "spumoni_tpu_torch"
OUT_EXTS = {"report": ".report", "pml": ".pseudo_lengths",
            "lengths": ".lengths", "pointers": ".pointers",
            "docs": ".doc_numbers"}
MARKER = "benchmark.clock"


def _log(msg: str) -> None:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)


class Refused(Exception):
    """The run cannot give a result (no card, a forbidden import)."""


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(workload: str, root: str = ROOT):
    """(BENCHMARK.json, workload entry, configuration, traffic) by name."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    wl = {w["name"]: w for w in bench["workloads"]}[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(os.path.join(root, cfg_entry["file"]))
    cell = load_json(os.path.join(root, "benchmark", "cells",
                                  wl["traffic"] + ".json"))
    return bench, wl, config, cell


def metric_names(bench: dict, workload: str, trace: bool) -> list[str]:
    e2e = [m["name"] for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    return [m["name"] for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and (m.get("workloads") or m["moves"] in e2e)]


def metric_units(bench: dict) -> dict:
    return {m["name"]: m["unit"]
            for m in bench["end_to_end"] + bench["per_layer"]}


def reader(name: str, root: str = ROOT):
    path = os.path.join(root, "benchmark", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: spumoni_tpu_torch is not spumoni_tpu)."""
    modules = sys.modules if modules is None else modules
    return sorted(n for n in modules if top_level(n) in FORBIDDEN)


def reference_imports(root: str = ROOT) -> list[str]:
    """Imports of the reference's sources that name JAX, the JAX package or
    the program (by whole top-level name)."""
    bad = []
    ref = os.path.join(root, "benchmark", "reference")
    for fn in sorted(os.listdir(ref)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ref, fn)) as f:
            tree = ast.parse(f.read(), fn)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and not node.level:
                names = [node.module or ""]
            bad += [f"{fn}: {n}" for n in names
                    if top_level(n) in FORBIDDEN | {PROGRAM}]
    return bad


class Readings:
    """What the readers see."""

    def __init__(self, **kw):
        self.spans = None
        self.device = None
        self.symbols_per_call = None
        self.__dict__.update(kw)


def _out_paths(prefix: str, flags) -> dict:
    out = {}
    if "-c" in flags:
        out["report"] = prefix + OUT_EXTS["report"]
    if "--report-only" not in flags:
        if "-M" in flags:
            out["lengths"] = prefix + OUT_EXTS["lengths"]
            out["pointers"] = prefix + OUT_EXTS["pointers"]
        else:
            out["pml"] = prefix + OUT_EXTS["pml"]
        if "-d" in flags:
            out["docs"] = prefix + OUT_EXTS["docs"]
    return out


def _sha(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for blk in iter(lambda: f.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


def _records(path: str) -> dict:
    """{read id: values} of a value file (values print as unsigned 64-bit;
    read back as int64)."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return {lines[i][1:].decode(): lines[i + 1]
            for i in range(0, len(lines) - 1, 2)}


def _values(line: bytes) -> np.ndarray:
    return np.array(line.split(), np.uint64).view(np.int64)


def _report(path: str):
    with open(path) as f:
        lines = f.read().splitlines(keepends=True)
    return (lines[0] if lines else ""), {ln.split()[0]: ln
                                         for ln in lines[1:] if ln.strip()}


def sample_reads(ids, seqs, n_check: int, seed: int) -> list[int]:
    """Indices of the reads the reference checks: drawn from the seed, with
    the longest read among them."""
    n = len(ids)
    pick = traffic.rng(seed, 3).choice(n, size=min(n_check, n),
                                       replace=False)
    longest = int(np.argmax([len(s) for s in seqs]))
    return sorted(set(int(i) for i in pick) | {longest})


def expected(dep: Deployment, cell: dict, ids, seqs, picks, flags,
             down_on_tie: bool = True) -> dict:
    """The reference's report header, report lines and value records of the
    picked reads."""
    mode = "ms" if "-M" in flags else "pml"
    bw = int(flags[flags.index("-w") + 1]) if "-w" in flags else 150
    thr = dep.threshold(mode, down_on_tie)
    syms = [dep.symbols(seqs[i]) for i in picks]
    lens, ptrs, docs = dep.values(syms, mode, down_on_tie)
    exp = {"header": report_header(thr), "lines": {}, "values": {}}
    for j, i in enumerate(picks):
        rid = ids[i]
        exp["lines"][rid] = report_line(rid, lens[j], bw, thr)
        rec = {("lengths" if mode == "ms" else "pml"): lens[j]}
        if ptrs is not None:
            rec["pointers"] = ptrs[j]
        if docs is not None and "-d" in flags:
            rec["docs"] = docs[j]
        exp["values"][rid] = rec
    return exp


def compare(exp: dict, got: dict, flags, n_reads: int) -> dict:
    """The numbers compared, each {value, limit}. `got` holds the program's
    parsed files of one call: `report` (header, lines) and value records."""
    checks = {}
    if "-c" in flags:
        header, lines = got["report"]
        wrong = int(header != exp["header"])
        wrong += sum(lines.get(rid) != ln for rid, ln in exp["lines"].items())
        checks["report_lines_wrong"] = wrong
        missing = n_reads - len(lines)
    else:
        missing = 0
    kinds = [k for k in ("pml", "lengths", "pointers", "docs") if k in got]
    if kinds:
        wrong = 0
        for rid, rec in exp["values"].items():
            for k in kinds:
                line = got[k].get(rid)
                if line is None or not np.array_equal(_values(line), rec[k]):
                    wrong += 1
                    break
        checks["value_records_wrong"] = wrong
        missing = max([missing] + [n_reads - len(got[k]) for k in kinds])
    checks["records_missing"] = max(missing, 0)
    return {k: {"value": v, "limit": 0} for k, v in checks.items()}


def parse_outputs(paths: dict) -> dict:
    got = {}
    for k, p in paths.items():
        got[k] = _report(p) if k == "report" else _records(p)
    return got


def _card(chips: int):
    if not torch.cuda.is_available():
        raise Refused("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < chips:
        raise Refused(f"the cell needs {chips} GPUs; "
                      f"{torch.cuda.device_count()} visible")
    limit = None
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits", "-i", "0"],
                           capture_output=True, text=True, timeout=30)
        limit = float(r.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "power_limit_w": limit}


def _install_spans(spans):
    from spumoni_tpu_torch.classify import binmax, report
    from spumoni_tpu_torch.engine.scan_engine import ScanEngine
    from spumoni_tpu_torch.io import fastx_batch, minimizers

    spans.wrap_generator(fastx_batch, "iter_packed_batches", "parse")
    spans.wrap(ScanEngine, "stage", "stage")
    spans.wrap(minimizers, "digest_packed", "digest")
    spans.wrap(report, "report_line", "writer")
    spans.wrap(report, "write_values_record", "writer")
    spans.wrap(binmax, "classify", "writer")


class HostClock:
    """Per call of the window: the seconds the garbage collector ran (in any
    thread) and the process's resident bytes at its end, for the log."""

    def __init__(self):
        self.gc_s = 0.0
        self._t = 0.0
        gc.callbacks.append(self._gc)

    def _gc(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.gc_s += time.perf_counter() - self._t

    def close(self):
        gc.callbacks.remove(self._gc)

    @staticmethod
    def rss_bytes() -> int:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE")


def _warm_up(cli, pipeline, argv, on_card: bool) -> list[int]:
    """The set-up's whole `run` call; returns the device bytes that each
    engine's index load took (make_engine, measured around it)."""
    make, loads = pipeline.make_engine, []

    def measured(*args, **kw):
        m0 = torch.cuda.memory_allocated() if on_card else 0
        engine = make(*args, **kw)
        if on_card:
            loads.append(torch.cuda.memory_allocated() - m0)
        return engine

    pipeline.make_engine = measured
    try:
        cli.main(argv)
    finally:
        pipeline.make_engine = make
    return loads


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", root: str = ROOT, config=None, cell=None,
             work=None, t_start: float = T_START) -> dict:
    """One run; returns the result line's object. `device="cpu"` (tests
    only) runs the program's plain versions and skips the card's readings."""
    bench, wl, cfg0, cell0 = cell_spec(workload, root)
    config = config or cfg0
    cell = cell or cell0
    flags = list(cell["flags"])
    on_card = device == "cuda"
    dev = _card(int(wl["chips"])) if on_card else None
    if not on_card:
        flags += ["--device", "cpu"]

    from spumoni_tpu_torch import cli, pipeline

    work = work or os.path.join(tempfile.gettempdir(), "spumoni_benchmark")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        strains = traffic.pangenome(config, seed)
        inputs = traffic.write_pangenome(work, strains, config["build"])
        prefix = os.path.join(work, "index")
        src = (["-i", inputs["list"]] if "list" in inputs
               else ["-r", inputs["fasta"]])
        t0 = time.perf_counter()
        cli.main(["build", *src, *config["build_flags"], "-o", prefix])
        t1 = time.perf_counter()
        ids, seqs = traffic.reads(cell, strains, seed)
        reads_path = os.path.join(work, "reads.fa")
        bases = traffic.write_reads(reads_path, ids, seqs)
        argv = ["run", "-r", prefix, "-p", reads_path, *flags]
        t2 = time.perf_counter()
        loads = _warm_up(cli, pipeline, argv, on_card)  # every shape
        _log(f"set-up: data and build {t1 - t_start:.1f} s (build "
             f"{t1 - t0:.1f} s), reads {t2 - t1:.1f} s, warm-up call "
             f"{time.perf_counter() - t2:.1f} s; the index on the device "
             f"{loads} bytes")
        out_paths = _out_paths(reads_path, flags)
        if on_card:
            torch.cuda.synchronize()
        setup_s = time.perf_counter() - t_start

        spans = prof = None
        if trace:
            from benchmark.trace import Spans
            spans = Spans()
            _install_spans(spans)
            if on_card:
                from torch.profiler import ProfilerActivity, profile
                prof = profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA])
                prof.__enter__()
        calls, kept = [], []
        host = HostClock()
        marker_t = None
        t_w0 = time.perf_counter()
        if prof is not None:
            marker_t = time.perf_counter()
            with torch.profiler.record_function(MARKER):
                pass
        while True:
            c0 = time.perf_counter()
            cli.main(argv)
            c1 = time.perf_counter()
            stream = float(pipeline.LAST_RUN_STATS["stream_s"])
            calls.append({"start": c0, "end": c1, "stream_s": stream,
                          "gc_s": host.gc_s, "rss": host.rss_bytes()})
            if spans is not None:
                spans.add("load", c0, max(c0, c1 - stream))
            k = len(calls) - 1
            moved = {}
            for name, p in out_paths.items():
                dst = f"{p}.call{k}"
                os.replace(p, dst)
                moved[name] = dst
            if kept:
                # the value files of all but the last call go while still
                # in the page cache: a window of value runs would otherwise
                # write GBs to the disk (and slow the host's later runs)
                for name, p in kept[-1].items():
                    if name != "report":
                        os.remove(p)
            kept.append(moved)
            if c1 - t_w0 >= seconds:
                break
        if on_card:
            torch.cuda.synchronize()
        host.close()
        window = (calls[0]["start"], calls[-1]["end"])
        device_trace = None
        if prof is not None:
            prof.__exit__(None, None, None)
            from benchmark.trace import DeviceTrace
            device_trace = DeviceTrace.from_profiler(prof, MARKER, marker_t,
                                                     window)
            del prof
        if spans is not None:
            spans.remove()
        memory_peak = None
        if on_card:
            memory_peak = int(torch.cuda.max_memory_allocated())
            torch.cuda.empty_cache()

        bad = forbidden_modules()
        if bad:
            raise Refused("loaded after the window: " + ", ".join(bad))
        bad = reference_imports(root)
        if bad:
            raise Refused("the reference imports " + ", ".join(bad))

        symbols = None
        if trace:
            if config["build"] == "digest":
                from benchmark.reference.digest import digest
                symbols = int(sum(len(digest(s)) for s in seqs))
            else:
                symbols = bases
        ctx = Readings(setup_s=setup_s, window_s=window[1] - window[0],
                       calls=calls, bases_per_call=bases,
                       reads_per_call=len(ids), spans=spans,
                       device=device_trace, symbols_per_call=symbols,
                       flags=flags)
        units = metric_units(bench)
        metrics = {}
        for name in metric_names(bench, workload, trace):
            v = reader(name, root)(ctx)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": units[name]}

        _log(f"window: {len(calls)} calls in {window[1] - window[0]:.2f} s; "
             + ", ".join(f"{c['end'] - c['start']:.2f}" for c in calls))
        _log("window: gc s at each call's end "
             + ", ".join(f"{c['gc_s']:.3f}" for c in calls)
             + "; resident GB " + ", ".join(f"{c['rss'] / 1e9:.2f}"
                                            for c in calls))
        # correctness: the reference, after the window
        t0 = time.perf_counter()
        last = kept[-1]
        differing = 0
        if "report" in last:
            ref_sum = _sha(last["report"])
            differing = sum(_sha(c["report"]) != ref_sum for c in kept[:-1])
        dep = Deployment(strains, config["build"], device)
        picks = sample_reads(ids, seqs, int(cell["check_reads"]), seed)
        t1 = time.perf_counter()
        exp = expected(dep, cell, ids, seqs, picks, flags)
        checks = compare(exp, parse_outputs(last), flags, len(ids))
        _log(f"check: reference index {t1 - t0:.1f} s, all of it "
             f"{time.perf_counter() - t0:.1f} s")
        checks["calls_differing"] = {"value": differing, "limit": 0}
        correct = all(c["value"] <= c["limit"] for c in checks.values())

        result = {"correct": bool(correct),
                  "attempted": len(ids) * len(calls), "failed": 0,
                  "metrics": metrics}
        if on_card:
            result["device"] = dict(dev, memory_peak_bytes=memory_peak)
            if trace:
                busy = device_trace.busy_s() if device_trace else None
                result["device"].update(busy_s=busy,
                                        window_s=window[1] - window[0])
        if trace and device_trace is not None:
            result["breakdown"] = {
                "device_ops": device_trace.top_ops(),
                "idle_gaps": device_trace.idle_gaps(spans)}
        result["checks"] = checks
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result = run_cell(args.workload, args.seed, args.seconds,
                          bool(args.trace))
    except Refused as e:
        print(f"benchmark: no result: {e}", file=sys.stderr)
        return 2
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
