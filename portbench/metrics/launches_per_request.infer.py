"""``launches_per_request.infer``: device kernels, copies and memsets per request, from the
profiler's trace of the profiled requests."""


def read(s):
    if s["role"] != "infer" or not s.get("device_ops") or not s["profiled_steps"]:
        return None
    return s["device_ops"] / s["profiled_steps"]
