"""Graphs a call captures: the executor's "capture" spans over its
"call-setup" spans, over the instance's passes of a traced run. 0 where
the calls capture nothing (graphs kept from an earlier call); None where
the program opens no "call-setup" span (the CPU, or a program without
the spans)."""


def read(rec):
    calls = rec.spans.get("call-setup", (0, 0.0))[0]
    if not calls:
        return None
    return rec.spans.get("capture", (0, 0.0))[0] / calls
