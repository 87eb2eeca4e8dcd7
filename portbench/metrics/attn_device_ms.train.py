"""``attn_device_ms.train``: device milliseconds per step in the fused attention kernels,
forward and backward (PyTorch's memory-efficient kernels, ``fmha_cutlassF*`` and
``fmha_cutlassB*`` by name), over the profiled steps, from the trace's top operations by
device time.  That list is cut after ``TOP`` entries; where it is full and lacks the
forward or the backward kernel, the part cut away is unknown and the reader gives nothing."""

TOP = 10  # the length of ``breakdown["device_ops"]`` (``tracing._top``)
FORWARD, BACKWARD = "fmha_cutlassF", "fmha_cutlassB"


def read(s):
    ops = (s.get("breakdown") or {}).get("device_ops") or []
    if s["role"] != "train" or not s["profiled_steps"]:
        return None
    matched = [(name, t) for name, t in ops if name.startswith((FORWARD, BACKWARD))]
    found = {name[:len(FORWARD)] for name, _ in matched}
    if not matched or (len(ops) >= TOP and found != {FORWARD, BACKWARD}):
        return None
    return 1e3 * sum(t for _, t in matched) / s["profiled_steps"]
