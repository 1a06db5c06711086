"""The share of the profiled passes' executor calls (the span the
benchmark's clock times, set-up and captures included) in which no
operation ran on the device (``torch.profiler``'s device activity)."""


def read(rec):
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)
