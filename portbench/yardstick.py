"""The benchmark's arithmetic: peaks, a conv call's work and bound,
percentiles, the union of intervals, and the comparison's gaps.

The bound arithmetic is ``chip_smoke.py``'s ``bound()``: useful operations
``2 * pairs * Cin * Cout`` over the published dense TF32 rate, and bytes
(each input read once, the output written once) over the HBM rate,
whichever is larger.  The interval union is ``tools/profile_request.py``'s
``busy_us``.
"""

from __future__ import annotations

import statistics

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}  # float32 on the TF32 tensor cores
HBM_BYTES_PER_S = 3.35e12
PARTS = ("fwd", "dx", "dw")


def conv_work(pairs, n_in, n_out, volume, cin, cout, part, itemsize=4):
    """(useful operations, bytes) of one part of a sparse conv call:
    the forward, the input gradient or the weight gradient."""
    flop = 2.0 * pairs * cin * cout
    w = volume * cin * cout
    if part == "fwd":
        nbytes = n_in * cin + w + n_out * cout
    elif part == "dx":
        nbytes = n_out * cout + w + n_in * cin
    elif part == "dw":
        nbytes = n_in * cin + n_out * cout + w
    else:
        raise ValueError(part)
    return flop, nbytes * itemsize


def bound_s(flop, nbytes, precision="float32"):
    """The least time the card could take: operations or bytes."""
    return max(flop / PEAK_FLOPS[precision], nbytes / HBM_BYTES_PER_S)


def union_length(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def gaps(intervals, lo, hi):
    """The (start, end) stretches of [lo, hi] that no interval covers."""
    out, end = [], lo
    for s, e in sorted(intervals):
        if s > end:
            out.append((end, min(s, hi)))
        end = max(end, e)
        if end >= hi:
            break
    if end < hi:
        out.append((end, hi))
    return [(s, e) for s, e in out if e > s]


def percentile(values, q):
    """The q-th percentile (0 < q < 100) by linear interpolation between
    closest ranks, as ``statistics.quantiles(method="inclusive")``."""
    values = sorted(values)
    if not values:
        raise ValueError("no values")
    if len(values) == 1:
        return float(values[0])
    pos = (len(values) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(values) - 1)
    return float(values[lo] + (values[hi] - values[lo]) * (pos - lo))


def spread(values):
    """Interquartile range over the median, with Python's quartiles."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med


def norm_gap(ours, theirs, floor):
    """|‖ours‖ - ‖theirs‖| over the larger of ‖theirs‖ and ``floor``."""
    return abs(ours - theirs) / max(theirs, floor)


def worst_leaf_gap(ours: dict, theirs: dict, keep=None):
    """The worst leaf's gap between two dicts of leaf norms, against the
    leaf's reference norm or the median leaf's, whichever is larger."""
    names = [n for n in theirs if keep is None or n in keep]
    floor = statistics.median(theirs[n] for n in theirs)
    return max(norm_gap(ours[n], theirs[n], floor) for n in names)


def median_leaf_gap(ours: dict, theirs: dict, keep=None):
    """The median over leaves of the gap ``worst_leaf_gap`` takes the
    largest of."""
    names = [n for n in theirs if keep is None or n in keep]
    floor = statistics.median(theirs[n] for n in theirs)
    return statistics.median(norm_gap(ours[n], theirs[n], floor) for n in names)
