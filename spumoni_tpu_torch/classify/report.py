"""Output writers: *.pseudo_lengths / *.lengths / *.pointers / *.doc_numbers
and the classification *.report, byte-compatible with the reference
(src/compute_ms_pml.cpp:845-1217).

Formatting notes (all reproduced):
  * value files: ">id\\n" then space-separated values each FOLLOWED by a
    space (ostream_iterator semantics), then "\\n";
  * report: std::setw left-aligned columns, precision(3) general float
    formatting for the average;
  * MS pointers that underflowed are printed as unsigned 64-bit
    (compute_ms_pml.cpp:582 uses size_t arithmetic).
"""

from __future__ import annotations

import io

import numpy as np


def _fmt_value(v: int) -> str:
    v = int(v)
    if v < 0:
        v += 1 << 64  # reproduce unsigned underflow output
    return str(v)


def write_values_record(f, read_id: str, values) -> None:
    """Writes one '>id\\nv v v \\n' record; accepts text- or binary-mode
    files. Integer numpy arrays go through the native decimal formatter
    (byte-identical, ~20-40x faster — the writers otherwise bound
    end-to-end throughput like the reference's iostream loops,
    compute_ms_pml.cpp:1001-1021)."""
    binary = isinstance(f, io.BufferedIOBase) or isinstance(f, io.RawIOBase)
    if isinstance(values, np.ndarray) and values.dtype.kind in "iu":
        from ..native import format_values
        body = format_values(values)
    else:
        body = "".join(_fmt_value(v) + " " for v in values).encode("ascii")
    rec = b">" + read_id.encode() + b"\n" + body + b"\n"
    f.write(rec if binary else rec.decode("ascii"))


def _cpp_general_float(x: float, precision: int = 3) -> str:
    """std::ostream default (general) formatting with given precision."""
    s = f"{x:.{precision}g}"
    # C++ prints e.g. 1e+06 like Python's %g; also matches inf/nan closely
    return s


def report_header(max_value_thr: int) -> str:
    """compute_ms_pml.cpp:877-886."""
    return (f"{'read id:':<30}{'status:':<15}{'avg max-value (thr=':<19}"
            f"{max_value_thr:<2}{'):':<5}{'above thr:':<12}{'below thr:':<12}\n")


def report_line(read_id: str, status: str, avg_max: float, above: int,
                below: int) -> str:
    """compute_ms_pml.cpp:1012-1019."""
    return (f"{read_id:<30}{status:<15}{_cpp_general_float(avg_max):<26}"
            f"{above:<12}{below:<12}\n")


def ks_report_header(ks_threshold: float) -> str:
    """KS-test report header (ks_test.cpp:40-47)."""
    thr = _cpp_general_float(ks_threshold, 4)
    return (f"{'read id:':<20}{'status:':<15}{'avg ks-stat (thr=':<17}"
            f"{thr:<6}{'):':<5}{'above thr:':<12}{'below thr:':<12}\n")


def ks_report_line(read_id: str, status: str, avg_ks: float, above: int,
                   below: int) -> str:
    """The KS classification line of the (build-time live) KS path
    (compute_ms_pml.cpp:948-966,1012-1019)."""
    return (f"{read_id:<30}{status:<15}{_cpp_general_float(avg_ks):<26}"
            f"{above:<12}{below:<12}\n")
