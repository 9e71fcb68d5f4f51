"""setup_s: seconds from process start to the window's start."""

from benchmark.readers import setup_s as read  # noqa: F401
