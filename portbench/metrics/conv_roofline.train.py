"""``conv_roofline.train``: the summed bound of every sparse conv call of the profiled
steps (operations or bytes, whichever is larger, per part) over the
device time of every kernel launched inside the benchmark's ranges around
the conv modules' forward and backward, leaving out the coordinate manager's
calls inside them; in percent."""


def read(s):
    if s["role"] != "train" or not s.get("conv_device_s") or not s.get("conv_bound_s"):
        return None
    return 100.0 * s["conv_bound_s"] / s["conv_device_s"]
