"""Mean device milliseconds of a drain (with the share refresh in the
escrow regime), from the executor's CUDA events, over the unprofiled
passes' windows."""


def read(rec):
    ms = [d for _, d, _, _, profiled in rec.windows
          if d is not None and not profiled]
    return sum(ms) / len(ms) if ms else None
