"""Device time per map in every kernel that PyTorch did not launch: the
program's own kernels, ms."""


def read(trace):
    own = [e - s for _, s, e, by_torch in trace.kernels if not by_torch]
    if not own or not trace.maps:
        return None
    return 1e3 * sum(own) / trace.maps
