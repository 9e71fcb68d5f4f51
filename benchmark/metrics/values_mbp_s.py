"""values_mbp_s: input Mbp of value-file calls per second of the window."""

from benchmark.readers import mbp_s as read  # noqa: F401
