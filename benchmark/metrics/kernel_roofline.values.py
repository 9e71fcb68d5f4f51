"""kernel_roofline.values: kernels layer, value cells."""

from benchmark.readers import kernel_roofline as read  # noqa: F401
