"""``mfu.train``: the useful conv operations of a step (forward, input and weight gradients) over
the mean time of the steps the profiler did not record, against the
published dense peak of the configuration's precision, in percent."""


def read(s):
    if not s["on_card"] or s["role"] != "train" or not s.get("flop_per_step") or not s["unprofiled_step_s"]:
        return None
    mean = sum(s["unprofiled_step_s"]) / len(s["unprofiled_step_s"])
    return 100.0 * s["flop_per_step"] / mean / s["peak_flops"]
