"""load_share.values: run-loop layer (cli, pipeline.run, make_engine), value cells."""

from benchmark.readers import load_share as read  # noqa: F401
