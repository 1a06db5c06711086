"""A kernel's share of its roofline over the profiled passes: the least
time its problems need (``frozen/kernel_bytes.py`` over the peaks of
``frozen/peaks.py``) over its device time in the trace."""

from portbench import tracing
from portbench.frozen import peaks


def share(rec, kernel: str, symbol: str):
    if rec.trace is None or kernel not in rec.kernel_bytes:
        return None
    seconds = tracing.kernel_seconds(rec.trace, symbol)
    if seconds <= 0:
        return None
    nbytes, ops = rec.kernel_bytes[kernel]
    least = peaks.bound_s(nbytes * rec.traced_passes,
                          ops * rec.traced_passes)
    return 100.0 * least / seconds
