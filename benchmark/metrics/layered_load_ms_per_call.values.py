"""layered_load_ms_per_call.values: the load of the layered index a call
pays, ms a call (run loop: make_engine, engine/layered), value cells."""

from benchmark.layered_load import (  # noqa: F401
    layered_load_ms_per_call as read)
