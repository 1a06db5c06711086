"""Seconds from the harness's first statement to the first timed call:
imports, CUDA start, the tables, the stream, the kernel builds, the warm
call with its captures, and the snapshot's restore."""


def read(rec):
    return rec.setup_s
