"""Kernel 3b: the encoder GRU's backward grids (``gru_bwd*``) against the
least time of the recurrence's backward over the window's real source
tokens, both directions (``counts.gru_bwd_counts``), in %."""

from portbench import counts, trace


def read(r):
    t = r.get("trace")
    if r["kind"] != "train" or t is None:
        return None
    dev_s = trace.kernel_s(t["kernels"], "gru_bwd")
    if dev_s <= 0:
        return None
    layers = r["m"]["enc_layers"]
    row_steps = 2 * layers * sum(T for T, _ in r["pairs"])
    fl, nb = counts.gru_bwd_counts(r["m"], row_steps,
                                   2 * layers * r["steps"], r["dtype"])
    return 100.0 * counts.least_s(fl, nb, r["dtype"]) / dev_s
