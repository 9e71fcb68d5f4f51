"""writer_ms_per_value_mb.values: the writer thread's cost a byte of value
text, ms per MB (writer thread).

The program's `writer.format` spans of the window's calls over their
counter `value_bytes` (the value files' growth a batch, every value file)
/ 1e6. None where no call counted `value_bytes` (a report-only call, or a
program without the counter).
"""

from benchmark.program_trace import intervals, length, program, window


def read(ctx):
    snap = program(ctx)
    if snap is None:
        return None
    nbytes = sum(c["n"] for c in snap["counts"]
                 if c["name"] == "value_bytes")
    if not nbytes:
        return None
    fmt = length(intervals(snap["spans"], ("writer.format",), window(ctx)))
    return 1e3 * fmt / (nbytes / 1e6)
