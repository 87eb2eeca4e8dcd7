"""``device_idle_pct.infer``: the share of the profiled requests' wall time in which no
kernel, copy or memset ran on the device, in percent."""


def read(s):
    if s["role"] != "infer" or not s.get("window_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
