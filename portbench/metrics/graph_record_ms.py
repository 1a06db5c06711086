"""Host milliseconds a call spends recording its graphs: the executor's
"graph-record" spans (each ``torch.cuda.graph`` block, the chunk's
enqueue into the graph and its instantiation) over its "call-setup"
spans' count, over the instance's passes of a traced run. 0 where the
calls capture nothing; None where the program opens no "call-setup" span
(the CPU, or a program without the spans)."""


def read(rec):
    calls = rec.spans.get("call-setup", (0, 0.0))[0]
    if not calls:
        return None
    return rec.spans.get("graph-record", (0, 0.0))[1] / calls * 1e3
