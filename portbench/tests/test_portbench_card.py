"""On the card: each cell's control (the reference at the next precision
down, in the program's place) comes out not correct, and the program's own
run correct, over a short window at the cell's own load. Run on the card
with ``python3 -m pytest portbench/tests -m card --confcutdir=portbench``."""

import time

import pytest

from portbench import run

CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


@pytest.mark.card
@pytest.mark.parametrize("cell", ["m30k.decode", "m30k.train",
                                  "m30k.decode_bf16"])
def test_control_is_not_correct_and_the_program_is(card, cell):
    import importlib

    bench = run.load_benchmark()
    w = run.workload(bench, cell)
    traffic = run.traffic_of(w)
    stated = run.config_of(bench, w)["precision"]
    precision = CONTROL[stated["train" if traffic["kind"] == "train"
                               else "decode"]]
    drv = importlib.import_module(f"portbench.drivers.{traffic['kind']}")
    seed = 2 ** 31 + 101
    ok = run.execute(bench, w, seed, 2.0, False, card, time.perf_counter())
    assert ok["correct"], ok["checks"]
    bad = run.execute(bench, w, seed, 2.0, False, card, time.perf_counter(),
                      replace=drv.control(precision))
    assert not bad["correct"], bad["checks"]
