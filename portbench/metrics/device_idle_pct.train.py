"""``device_idle_pct.train``: the share of the profiled steps' wall time in which no
kernel, copy or memset ran on the device, in percent."""


def read(s):
    if s["role"] != "train" or not s.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
