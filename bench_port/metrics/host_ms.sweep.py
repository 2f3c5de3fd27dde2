"""Host time inside each call into ``tracer.power_map``, ms per map: the
request's dispatch, its route and input caches, and every host step of the
tables and launches that the call makes before it returns.  Read from the
``perf_counter`` spans of the untraced window that the traced run measures
first, since the profiler slows the host's dispatch (+79% a basic map)."""


def read(trace):
    spans = trace.plain.spans.get("power_map", []) if trace.plain is not None else []
    if not spans:
        return None
    return 1e3 * sum(e - s for s, e in spans) / len(spans)
