"""Device time per map in kernels that PyTorch launched (their launch lies
inside an ``aten::`` operator): the culling tables' torch ops, ms."""


def read(trace):
    own = [e - s for _, s, e, by_torch in trace.kernels if by_torch]
    if not own or not trace.maps:
        return None
    return 1e3 * sum(own) / trace.maps
