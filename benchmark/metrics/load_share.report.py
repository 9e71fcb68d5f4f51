"""load_share.report: run-loop layer (cli, pipeline.run, make_engine), report cells."""

from benchmark.readers import load_share as read  # noqa: F401
