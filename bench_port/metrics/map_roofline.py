"""The map's least time on the card over the device time per map of all
its kernels, %.  The least time is the larger of the request's operations
over the FP32 peak and its bytes over the HBM peak (``roofline/counts.py``),
so it reads the same work whatever implements the map."""


def read(trace):
    kernel_s = sum(e - s for _, s, e, _ in trace.kernels)
    if trace.least_s is None or not trace.maps or kernel_s <= 0:
        return None
    return 100.0 * trace.least_s / (kernel_s / trace.maps)
