"""``attn_kernel_ms.train``: device milliseconds per step in the port's own attention
kernels, forward and backward (``csrc/serialized_attention.cu``: names holding
``attention_fwd_3xtf32`` and ``attention_bwd_``, the backward's Delta pass included),
over the profiled steps, from the trace's top operations by device time.  That list is cut
after ``TOP`` entries; where it is full and lacks the forward or the backward kernel, the
part cut away is unknown and the reader gives nothing.  A program without these kernels
gives nothing."""

TOP = 10  # the length of ``breakdown["device_ops"]`` (``tracing._top``)
FORWARD, BACKWARD = "attention_fwd_3xtf32", "attention_bwd_"
MAIN = "attention_bwd_3xtf32"  # the backward's kernel that has to be in the list


def read(s):
    ops = (s.get("breakdown") or {}).get("device_ops") or []
    if s.get("role") != "train" or not s.get("profiled_steps"):
        return None
    matched = [(name, t) for name, t in ops if FORWARD in name or BACKWARD in name]
    has = (any(FORWARD in name for name, _ in matched), any(MAIN in name for name, _ in matched))
    if not matched or (len(ops) >= TOP and not all(has)):
        return None
    return 1e3 * sum(t for _, t in matched) / s["profiled_steps"]
