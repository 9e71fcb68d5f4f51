"""How each metric is read from a run's readings (`Readings` in run.py).

Every metric has a file `metrics/<name>.py` that binds `read` to one of
these. A reader returns None where its run holds nothing to read, and the
metric is then left out of the result line.
"""

from __future__ import annotations

from . import roofline


def _bases(ctx) -> int:
    return ctx.bases_per_call * len(ctx.calls)


def mbp_s(ctx):
    """Input read bases of the window's calls (counted before digestion)
    over the wall time from the first call's start to the last's end."""
    return _bases(ctx) / 1e6 / ctx.window_s


def setup_s(ctx):
    return ctx.setup_s


def load_share(ctx):
    """Share of the window outside the calls' streaming loops (index load,
    engine and null database set-up, file opening), in %."""
    stream = sum(c["stream_s"] for c in ctx.calls)
    return 100.0 * (ctx.window_s - stream) / ctx.window_s


def _ms_per_mbp(ctx, layers):
    if ctx.spans is None:
        return None
    got = [ctx.spans.total[x] for x in layers if x in ctx.spans.total]
    if not got:
        return None
    return 1e3 * sum(got) / (_bases(ctx) / 1e6)


def input_ms_per_mbp(ctx):
    return _ms_per_mbp(ctx, ("parse", "stage"))


def digest_ms_per_mbp(ctx):
    return _ms_per_mbp(ctx, ("digest",))


def writer_ms_per_mbp(ctx):
    return _ms_per_mbp(ctx, ("writer",))


def kernel_roofline(ctx):
    """The least time of the window's scans (roofline.py) over the summed
    time of every kernel the profiler saw in the window, in %."""
    if ctx.device is None or ctx.symbols_per_call is None:
        return None
    ks = ctx.device.kernel_s()
    if ks <= 0:
        return None
    least = len(ctx.calls) * roofline.least_seconds(
        ctx.flags, ctx.symbols_per_call, ctx.reads_per_call)
    return 100.0 * least / ks


def device_idle_share(ctx):
    """1 - (union of kernel and copy intervals) / window, in %."""
    if ctx.device is None:
        return None
    busy = ctx.device.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / ctx.window_s)
