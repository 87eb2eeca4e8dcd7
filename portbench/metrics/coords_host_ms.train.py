"""``coords_host_ms.train``: host milliseconds inside the coordinate manager's public calls
(outermost only, and the generative decoder's ``keep.any()`` syncs) per step, over the steps the profiler did not record."""


def read(s):
    if s["role"] != "train" or not s["coords_host_s"]:
        return None
    return 1e3 * sum(s["coords_host_s"]) / len(s["coords_host_s"])
