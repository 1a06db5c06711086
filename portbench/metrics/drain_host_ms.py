"""Mean host milliseconds to enqueue a drain: the unsynced
"outbox-drain" and "share-refresh" spans of an ``ObsSession`` with
metrics off, over the unprofiled passes."""


def read(rec):
    spans = [rec.spans[k] for k in ("outbox-drain", "share-refresh")
             if k in rec.spans]
    n = sum(c for c, _ in spans)
    return sum(s for _, s in spans) / n * 1e3 if n else None
