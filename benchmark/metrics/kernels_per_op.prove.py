"""Device kernels on the profiler's timeline per withdraw proof."""

from benchmark.readers import kernels_per_op as read  # noqa: F401
