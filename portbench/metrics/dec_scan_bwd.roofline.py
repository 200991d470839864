"""Kernel 5b: the grids named ``dec_scan_bwd*`` against the least time of
the decoder recurrence's backward over the window's real pairs
(``counts``), in %."""

from portbench import counts, trace


def read(r):
    t = r.get("trace")
    if r["kind"] != "train" or t is None:
        return None
    dev_s = trace.kernel_s(t["kernels"], "dec_scan_bwd")
    if dev_s <= 0:
        return None
    fl, nb = counts.dec_scan_bwd_counts(r["m"], r["pairs"], r["steps"],
                                        r["dtype"])
    return 100.0 * counts.least_s(fl, nb, r["dtype"]) / dev_s
