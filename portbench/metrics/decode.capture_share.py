"""Graph captures' share of the decode window: the host seconds the
program's ``translate_corpus`` calls report in ``capture_s`` (each call's
loop graphs' warm-ups and captures), summed over the window's calls, over
the window's wall clock, in %."""


def read(r):
    if r["kind"] != "decode" or not r["stats"]:
        return None
    return 100.0 * sum(s.get("capture_s", 0.0) for s in r["stats"]) / r["window_s"]
