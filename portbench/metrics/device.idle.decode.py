"""Share of the traced decode window in which no operation ran on the
device, in %."""


def read(r):
    t = r.get("trace")
    if r["kind"] != "decode" or t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
