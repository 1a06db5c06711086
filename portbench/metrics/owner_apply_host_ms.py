"""Host milliseconds a merge drain spends in its owners' stock applies:
the executor's "owner-apply" spans (one an owner, inside each timed
"outbox-drain") over the "outbox-drain" count, over the instance's passes
of a traced run. None where the program opens no "owner-apply" span (the
CPU, the escrow regime, or a program without the spans)."""


def read(rec):
    drains = rec.spans.get("outbox-drain", (0, 0.0))[0]
    if "owner-apply" not in rec.spans or not drains:
        return None
    return rec.spans["owner-apply"][1] / drains * 1e3
