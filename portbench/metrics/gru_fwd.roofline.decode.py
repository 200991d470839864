"""Kernel 2 (2b) in the decode's encoder: its grids' device time against
the least time of the recurrence the window's sentences needed, in %: per
direction, one (H) x (H, 3H) product a source token
(``counts.gru_fwd_counts``)."""

from portbench import counts, trace


def read(r):
    t = r.get("trace")
    if r["kind"] != "decode" or t is None:
        return None
    dev_s = trace.kernel_s(t["kernels"], "gru_fwd")
    if dev_s <= 0:
        return None
    layers = r["m"]["enc_layers"]
    row_steps = 2 * layers * sum(T for T, _ in r["sentences"])
    scans = 2 * layers * len(r["stats"])
    fl, nb = counts.gru_fwd_counts(r["m"], row_steps, scans, r["dtype"])
    return 100.0 * counts.least_s(fl, nb, r["dtype"]) / dev_s
