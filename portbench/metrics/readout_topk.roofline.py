"""Kernel 1 (1b): the readout's grids' device time against the least time
of the work the window's sentences needed, in %: each sentence's K beam
rows at each of its own decoded steps, a vocab projection with its
softmax and top-K (``counts.readout_counts``), W read once a beam step."""

from portbench import counts, trace


def read(r):
    t = r.get("trace")
    if r["kind"] != "decode" or t is None:
        return None
    dev_s = trace.kernel_s(t["kernels"], "readout_topk")
    if dev_s <= 0:
        return None
    rows = r["beams"] * sum(steps for _, steps in r["sentences"])
    calls = sum(s.get("beam_loop_steps", 0) for s in r["stats"])
    fl, nb = counts.readout_counts(r["m"], rows, calls, r["dtype"])
    return 100.0 * counts.least_s(fl, nb, r["dtype"]) / dev_s
