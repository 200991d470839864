"""The whole decode's share of the chip's peak, in %: the model operations
of each sentence's own encode and decoded steps (its served hypothesis,
<eos> included, times K beams; ``counts.decode_sentence_flops``), summed
over the window, over the window's wall clock and the peak of the dtype
the decode resolved to (fp32 165, bf16 989 TFLOP/s). Steps run for rows
already finished count as time, not as work."""

from portbench import counts


def read(r):
    if r["kind"] != "decode" or not r["sentences"]:
        return None
    fl = sum(counts.decode_sentence_flops(r["m"], T, steps, r["beams"])
             for T, steps in r["sentences"])
    return 100.0 * fl / r["window_s"] / counts.PEAK_FLOPS[r["dtype"]]
