"""Committed New-Orders of every pass over the benchmark's own clock
around each executor call (host clock; the call ends with the executor's
closing synchronise), its captures included."""


def read(rec):
    wall = sum(rec.walls)
    if not wall:
        return None
    return sum(c["neworders"] for c in rec.pass_counters) / wall
