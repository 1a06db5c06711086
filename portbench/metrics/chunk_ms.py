"""Mean device milliseconds of a chunk replay (the executor's CUDA events
around each ``graph.replay()``), over the unprofiled passes' windows."""


def read(rec):
    ms = [c for c, _, _, _, profiled in rec.windows
          if c is not None and not profiled]
    return sum(ms) / len(ms) if ms else None
