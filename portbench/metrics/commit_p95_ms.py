"""The 95th percentile over committed transactions of their window's
time: each window counts once a transaction it committed, with the
milliseconds between the benchmark's CUDA events where its "megastep"
span opens and where its drain's span closes, so the host's gaps inside
the window count. Windows of profiled passes are left out."""


def read(rec):
    rows = [(w, n) for _, _, w, n, profiled in rec.windows
            if w is not None and not profiled and n > 0]
    total = sum(n for _, n in rows)
    if not total:
        return None
    rows.sort()
    acc = 0
    for t, n in rows:
        acc += n
        if acc >= 0.95 * total:
            return t
    return rows[-1][0]
