"""kernel_roofline.report: kernels layer, report cells."""

from benchmark.readers import kernel_roofline as read  # noqa: F401
