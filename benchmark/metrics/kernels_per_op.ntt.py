"""Device kernels on the profiler's timeline per 2^20 transform."""

from benchmark.readers import kernels_per_op as read  # noqa: F401
