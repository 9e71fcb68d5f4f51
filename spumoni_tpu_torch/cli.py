"""Command-line interface of the port: `python -m spumoni_tpu_torch build |
import-ref | run`.

Takes the flags of spumoni_tpu/cli.py, except `--device`: `cuda` (the
default) runs the CUDA kernels on one GPU and raises without one; `cpu` is
the explicit choice of their plain PyTorch versions.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import _host


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="spumoni-tpu-torch",
        description="matching-statistics engine on NVIDIA GPUs "
                    "(PML computation and read classification)")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="build the MS/PML index for a reference")
    b.add_argument("-r", "--ref", dest="ref_file", default="",
                   help="path to reference FASTA (or general text with -g)")
    b.add_argument("-i", "--filelist", dest="input_list", default="",
                   help="file with a list of FASTA files to index")
    b.add_argument("-o", "--prefix", dest="output_prefix", required=True,
                   help="output prefix for index file(s)")
    b.add_argument("-M", "--MS", dest="ms_index", action="store_true",
                   help="build an index for computing MSs")
    b.add_argument("-P", "--PML", dest="pml_index", action="store_true",
                   help="build an index for computing PMLs")
    b.add_argument("-g", "--general-text", dest="is_general_text",
                   action="store_true", help="input is general text")
    b.add_argument("-c", "--no-rev-comp", dest="use_rev_comp",
                   action="store_false", help="do not add reverse complement")
    b.add_argument("-n", "--no-digest", dest="use_minimizers",
                   action="store_false", help="turn off minimizer digestion")
    b.add_argument("-m", "--minimizer-alphabet", dest="use_promotions",
                   action="store_true", help="use alphabet-promoted minimizers")
    b.add_argument("-a", "--dna-minimizer", dest="use_dna_letters",
                   action="store_true", help="use DNA-letter minimizers")
    b.add_argument("-K", "--small-window", dest="k", type=int, default=4)
    b.add_argument("-W", "--large-window", dest="w", type=int, default=11)
    b.add_argument("-d", "--doc-array", dest="build_doc", action="store_true",
                   help="build the document array")
    b.add_argument("-w", "--window", dest="bin_size", type=int, default=150,
                   help="classification bin size in bp")
    b.add_argument("-k", "--keep", dest="keep_files", action="store_true",
                   help="keep temporary files")
    b.add_argument("-v", "--verbose", action="store_true")
    b.add_argument("--build-method", dest="build_method",
                   choices=["auto", "sais", "pfp"], default="auto",
                   help="native construction path: in-memory SA-IS or "
                        "prefix-free parsing (identical output)")
    b.add_argument("--emit-ref-formats", dest="emit_ref_formats",
                   action="store_true",
                   help="also write the reference binary's 5-byte "
                        ".bwt.heads/.bwt.len/.thr_pos/.ssa/.esa intermediates")

    ir = sub.add_parser(
        "import-ref",
        help="build run-ready indexes from a reference spumoni build's "
             "intermediate files (.bwt.heads/.bwt.len/.thr_pos/.ssa/.esa)")
    ir.add_argument("-r", "--ref", dest="ref_file", required=True,
                    help="built-reference path the intermediates are named "
                         "after (usually <prefix>.fa)")
    ir.add_argument("-M", "--MS", dest="ms_index", action="store_true")
    ir.add_argument("-P", "--PML", dest="pml_index", action="store_true")
    ir.add_argument("-d", "--doc-array", dest="build_doc",
                    action="store_true")
    ir.add_argument("-m", "--minimizer-alphabet", dest="use_promotions",
                    action="store_true")
    ir.add_argument("-a", "--dna-minimizer", dest="use_dna_letters",
                    action="store_true")
    ir.add_argument("-K", "--small-window", dest="k", type=int, default=4)
    ir.add_argument("-W", "--large-window", dest="w", type=int, default=11)
    ir.add_argument("-w", "--window", dest="bin_size", type=int, default=150)

    r = sub.add_parser("run", help="compute PMLs for reads against an index")
    r.add_argument("-r", "--ref", dest="ref_file", required=True,
                   help="index prefix (as given to build -o)")
    r.add_argument("-p", "--pattern", dest="pattern_file", required=True,
                   help="query reads (FASTA/FASTQ)")
    r.add_argument("-M", "--MS", dest="ms_requested", action="store_true")
    r.add_argument("-P", "--PML", dest="pml_requested", action="store_true")
    r.add_argument("-g", "--general", dest="is_general_text",
                   action="store_true")
    r.add_argument("-d", "--doc-array", dest="use_doc", action="store_true")
    r.add_argument("-c", "--classify", dest="write_report", action="store_true")
    r.add_argument("-n", "--no-digest", dest="min_digest",
                   action="store_false")
    r.add_argument("-m", "--minimizer-alphabet", dest="use_promotions",
                   action="store_true")
    r.add_argument("-a", "--dna-minimizer", dest="use_dna_letters",
                   action="store_true")
    r.add_argument("-K", "--small-window", dest="k", type=int, default=4)
    r.add_argument("-W", "--large-window", dest="w", type=int, default=11)
    r.add_argument("-w", "--window", dest="bin_size", type=int, default=150)
    r.add_argument("-t", "--threads", dest="threads", type=int, default=1,
                   help="accepted for flag compatibility; unused")
    r.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda: the CUDA kernels on one GPU (default); cpu: "
                        "their plain PyTorch versions")
    r.add_argument("--engine", choices=["auto", "layered", "occ", "bits"],
                   default="auto",
                   help="index layout: auto (block-bits where it holds "
                        "the index and the mode, else layered), bits or "
                        "layered; occ is not in the port yet")
    r.add_argument("--batch-bases", dest="batch_bases", type=int,
                   default=33_554_432, help="bases per streamed batch")
    r.add_argument("--tp-devices", dest="tp_devices", type=int, default=0,
                   help="sharded index over this many devices (not in the "
                        "port yet)")
    r.add_argument("--ks-report", dest="ks_report", action="store_true",
                   help="classify via windowed KS test instead of bin-max")
    r.add_argument("--resume", dest="resume", action="store_true",
                   help="resume from the durable read cursor")
    r.add_argument("--report-only", dest="report_only", action="store_true",
                   help="with -c: write only the .report (no value files); "
                        "classification runs inside the kernel and only "
                        "per-read summaries leave the GPU")
    return p


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)
    kwargs = {k: v for k, v in vars(args).items() if k != "command"}
    if args.command == "build":
        if args.is_general_text:
            kwargs["use_minimizers"] = False
        _host.build(_host.BuildConfig(**kwargs))
        return 0
    if args.command == "import-ref":
        if not args.ms_index and not args.pml_index:
            raise SystemExit("import-ref: at least one of -M/-P is required")
        out = args.ref_file
        for ext in (".fa", ".bin"):
            if out.endswith(ext):
                out = out[:-len(ext)]
        _host.import_reference_build(
            _host.BuildConfig(output_prefix=out, **kwargs))
        return 0
    from .pipeline import RunConfig, run

    if args.is_general_text:
        kwargs["min_digest"] = False
    nproc = int(os.environ.get("SPUMONI_NUM_PROCESSES", "1"))
    run(RunConfig(process_count=nproc, **kwargs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
