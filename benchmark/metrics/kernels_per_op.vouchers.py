"""Device kernels on the profiler's timeline per batch of 4096 vouchers."""

from benchmark.readers import kernels_per_op as read  # noqa: F401
