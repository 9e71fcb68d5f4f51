"""The per-call load of a layered (`-m`) index, read from the program's
spans in `--trace 1` runs: `load.index` (the dense index from its npz) and
`load.layered` (the layered tables built from it: `load.fields`, the
fields, levels and char table, and `load.text`, the digested text)."""

from __future__ import annotations

from benchmark.program_trace import intervals, length, program, window

LOAD = ("load.index", "load.layered")


def layered_load_ms_per_call(ctx):
    """Σ (`load.index` + `load.layered`) of the window's calls over the
    calls, in ms. None where no call builds the layered tables (another
    engine, or a program without the span)."""
    snap = program(ctx)
    if snap is None or not any(s["name"] == "load.layered"
                               for s in snap["spans"]):
        return None
    calls = {s["call"] for s in snap["spans"] if s["name"] == "run"}
    load = length(intervals(snap["spans"], LOAD, window(ctx)))
    return 1e3 * load / len(calls)
