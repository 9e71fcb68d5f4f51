"""digest_ms_per_mbp.report: digestion layer (minimizers.digest_packed)."""

from benchmark.readers import digest_ms_per_mbp as read  # noqa: F401
