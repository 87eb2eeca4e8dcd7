"""``launches_per_step.train``: device kernels, copies and memsets per step, from the
profiler's trace of the profiled steps."""


def read(s):
    if s["role"] != "train" or not s.get("device_ops") or not s["profiled_steps"]:
        return None
    return s["device_ops"] / s["profiled_steps"]
