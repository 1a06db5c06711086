"""Kernel B2 (``txn_megastep_kernel``): its batches' least time over its
device time in the profiled passes, in percent."""

from portbench.metrics._roofline import share


def read(rec):
    return share(rec, "txn_megastep", "txn_megastep_kernel")
