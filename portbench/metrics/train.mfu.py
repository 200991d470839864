"""The whole train step's share of the chip's peak, in %: forward and
backward of every real pair of the window at its own lengths plus each
batch's VSE matrix (``counts.train_batch_flops``), over the window's wall
clock and the bf16 peak (989 TFLOP/s; the fp32 rate for an fp32 run)."""

from portbench import counts


def read(r):
    if r["kind"] != "train" or not r["pairs"]:
        return None
    fl = 0
    for sl, st in r["batches"]:
        fl += counts.train_batch_flops(r["m"], zip(sl.tolist(), st.tolist()))
    return 100.0 * fl / r["window_s"] / counts.PEAK_FLOPS[r["dtype"]]
