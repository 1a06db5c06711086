"""Kernel B3 (``ramp_read_kernel``): its Order-Status batches' least time
over its device time in the profiled passes, in percent."""

from portbench.metrics._roofline import share


def read(rec):
    return share(rec, "ramp_read", "ramp_read_kernel")
