"""Share of the untraced window in which no kernel or copy ran on the
card, %: one less the device's busy time per map, from the profiler's
timeline of the traced window (the profiler slows the host, not the
device's operations), times the maps per second of the untraced window
that the traced run measures first.  The traced window's own idle share,
which the profiler inflates, is ``device.busy_s`` over ``window_s``."""


def read(trace):
    plain = trace.plain
    if not trace.kernels or not trace.maps or plain is None or plain.seconds <= 0:
        return None
    busy_per_map = trace.busy_s() / trace.maps
    return 100.0 * (1.0 - busy_per_map * plain.maps / plain.seconds)
