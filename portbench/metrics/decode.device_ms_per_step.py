"""Device milliseconds a beam step: the traced window's device time over
the decoder steps its calls ran (``beam_loop_steps``, each chunk's loop
trips with the two-phase ladder's)."""


def read(r):
    t = r.get("trace")
    if r["kind"] != "decode" or t is None:
        return None
    steps = sum(s.get("beam_loop_steps", 0) for s in r["stats"])
    if not steps or t["busy_s"] <= 0:
        return None
    return 1e3 * t["busy_s"] / steps
