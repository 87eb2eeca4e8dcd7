"""``match_idle_ms.train``: device-idle milliseconds per step whose innermost benchmark range is
``match`` (Mask3D's Hungarian matcher's forward: its cost reads and the assignment on
the host; a range the traffic opens by module hooks), over the profiled steps, from
the trace's idle gaps by label.  That list is cut after ``TOP`` entries; where it is full and lacks
the label, the part cut away is unknown and the reader gives nothing; a shorter list that lacks it
reads 0."""

TOP = 10  # the length of ``breakdown["idle_gaps"]`` (``tracing._top``)
LABEL = "match"


def read(s):
    gaps = (s.get("breakdown") or {}).get("idle_gaps")
    if s.get("role") != "train" or not s.get("profiled_steps") or gaps is None:
        return None
    seconds = [t for name, t in gaps if name == LABEL]
    if not seconds and len(gaps) >= TOP:
        return None
    return 1e3 * sum(seconds) / s["profiled_steps"]
