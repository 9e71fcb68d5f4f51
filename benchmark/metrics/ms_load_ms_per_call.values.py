"""ms_load_ms_per_call.values: the index load that an MS / doc call pays
and a fast-start PML call does not, ms a call (run loop: make_engine,
engine/blockbits).

The program's spans `load.index` (the dense index), `load.msrows` (the
msrows from `.bbms.npz` or built) and `load.jumps` (the jump tables and
the text) of the window's calls, over the calls. None where the calls
load no msrows (a fast-start call, or a program without those spans).
"""

from benchmark.program_trace import intervals, length, program, window

LOAD = ("load.index", "load.msrows", "load.jumps")


def read(ctx):
    snap = program(ctx)
    if snap is None or not any(s["name"] in LOAD[1:]
                               for s in snap["spans"]):
        return None
    calls = {s["call"] for s in snap["spans"] if s["name"] == "run"}
    load = length(intervals(snap["spans"], LOAD, window(ctx)))
    return 1e3 * load / len(calls)
