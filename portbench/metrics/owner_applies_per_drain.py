"""Owner applies a merge drain makes: the executor's "owner-apply" spans
over its "outbox-drain" spans, over the instance's passes of a traced run
(the shard count while each owner takes the whole gathered outbox). None
where the program opens no "owner-apply" span (the CPU, the escrow
regime, or a program without the spans)."""


def read(rec):
    drains = rec.spans.get("outbox-drain", (0, 0.0))[0]
    if "owner-apply" not in rec.spans or not drains:
        return None
    return rec.spans["owner-apply"][0] / drains
