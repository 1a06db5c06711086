"""Mean host milliseconds of an executor call outside the executor's own
timed wall: the benchmark's clock around the call less the wall the call
returns (its warm-up-free set-up, the collection, the cache release and
the capture of its graphs), over the passes of the instance's stream,
which a traced run makes before it profiles."""


def read(rec):
    pairs = list(zip(rec.walls, rec.program_walls))[:rec.instance_passes]
    return (sum(w - p for w, p in pairs) / len(pairs) * 1e3
            if pairs else None)
