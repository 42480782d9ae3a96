"""map_knn_roofline (%): the least time the mapping k-NN's launches
in the profiled pass could take (pbench/cost.py: the larger of
operations over the float32 peak and bytes over the memory bandwidth,
counted from each call's inputs) over the device time the profiler gives
their kernels.  Nothing when the pass made no such call, none of their
kernels was found, or the card has no row of peaks."""


def read(s):
    if s.knn_least_s is None or s.knn_device_s <= 0 or not s.knn_matched:
        return None
    return 100.0 * s.knn_least_s / s.knn_device_s
