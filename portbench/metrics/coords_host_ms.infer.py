"""``coords_host_ms.infer``: host milliseconds inside the coordinate manager's public calls
(outermost only) per request, over the requests the profiler did not record."""


def read(s):
    if s["role"] != "infer" or not s["coords_host_s"]:
        return None
    return 1e3 * sum(s["coords_host_s"]) / len(s["coords_host_s"])
