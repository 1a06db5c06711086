"""Host milliseconds a call spends in the captures' release of the
allocator's cache: the executor's "cache-release" spans (each capture's
``torch.cuda.empty_cache()``, handing the last call's freed graph pool
back to the driver) over its "call-setup" spans' count, over the
instance's passes of a traced run. 0 where the calls capture nothing;
None where the program opens no "call-setup" span (the CPU, or a program
without the spans)."""


def read(rec):
    calls = rec.spans.get("call-setup", (0, 0.0))[0]
    if not calls:
        return None
    return rec.spans.get("cache-release", (0, 0.0))[1] / calls * 1e3
