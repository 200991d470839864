"""The harness on the CPU: its command line, the files it finds by name
(and dummies added as files only), the generators, the counts, and the
modules a run loads."""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import counts, gen, run, trace, weights

from .conftest import PKG, cpu_env, tiny_conf

ROOT = PKG.parent
M30K = json.loads((PKG / "configs" / "m30k_ende_vag.json").read_text())["model"]


def test_command_parses():
    a = run.parse(["--workload", "m30k.decode", "--seed", str(2 ** 31 + 7),
                   "--seconds", "20", "--trace", "1"])
    assert (a.workload, a.seed, a.seconds, a.trace) == (
        "m30k.decode", 2 ** 31 + 7, 20.0, 1)
    assert run.parse(["--workload", "x", "--seed", "0",
                      "--seconds", "1"]).trace == 0


@pytest.mark.parametrize("argv", [
    ["--seed", "1", "--seconds", "1"],
    ["--workload", "x", "--seed", "-1", "--seconds", "1"],
    ["--workload", "x", "--seed", "1", "--seconds", "0"],
    ["--workload", "x", "--seed", "1", "--seconds", "1", "--trace", "2"]])
def test_command_refuses(argv):
    with pytest.raises(SystemExit):
        run.parse(argv)


def test_every_cell_finds_its_files():
    bench = run.load_benchmark(ROOT)
    for w in bench["workloads"]:
        conf = run.config_of(bench, w, ROOT)
        traffic = run.traffic_of(w)
        limits = run.limits_of(w)
        assert conf["name"] == w["config"]
        assert traffic["kind"] in ("decode", "train")
        assert limits["numbers"]
        assert run.per_layer_of(bench, w), w["name"]
        assert {e["name"] for e in run.end_to_end_of(bench, w)} > {"setup_s"}
    for p in bench["per_layer"]:
        assert callable(run.metric_reader(p["name"]))


@pytest.mark.parametrize("kind", ["decode", "train"])
def test_readers_read_nothing_without_their_source(kind):
    """A reader with nothing to read returns None (its metric is then left
    out of the line), never 0."""
    bench = run.load_benchmark(ROOT)
    empty = {"kind": kind, "m": M30K, "dtype": "float32", "beams": 5,
             "window_s": 1.0, "trace": None, "stats": [], "sentences": [],
             "steps": 0, "singles": 0, "batches": [], "pairs": []}
    for p in bench["per_layer"]:
        assert run.metric_reader(p["name"])(empty) is None, p["name"]


def test_dummies_added_as_files_are_found(tiny_bench):
    """A configuration, a traffic mix, a cell's limits and a per-layer
    metric, each a new file, and new entries in BENCHMARK.json: the
    harness runs the new cell and reports the new metric, with no edit to
    a file that was there."""
    bench, root, pkg = tiny_bench
    before = {p: p.read_bytes() for p in pkg.rglob("*") if p.is_file()}
    (pkg / "configs" / "dummy.json").write_text(json.dumps(tiny_conf()))
    traffic = json.loads((pkg / "traffic" / "dec.json").read_text())
    traffic["sentences"] = 24
    (pkg / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (pkg / "limits" / "dummy.cell.json").write_text(
        (pkg / "limits" / "tiny.dec.json").read_text())
    (pkg / "metrics" / "dummy.calls.py").write_text(
        "def read(r):\n    return float(len(r['stats'])) or None\n")
    bench["configs"].append({"name": "dummy",
                             "file": "portbench/configs/dummy.json"})
    bench["workloads"].append({"name": "dummy.cell", "config": "dummy",
                               "traffic": "dummy_mix", "chips": 1})
    bench["end_to_end"][0]["workloads"].append("dummy.cell")
    bench["per_layer"].append({"name": "dummy.calls", "unit": "calls",
                               "moves": "decode_sent_per_s",
                               "workloads": ["dummy.cell"]})
    w = run.workload(bench, "dummy.cell")
    out = run.execute(bench, w, 5, 0.5, True, torch.device("cpu"),
                      time.perf_counter(), root=root, pkg=pkg)
    assert out["correct"] and out["attempted"] % 24 == 0
    assert out["metrics"]["dummy.calls"]["value"] >= 1
    assert "decode.mfu" in out["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


def test_generators_repeat_from_the_seed():
    traffic = json.loads((PKG / "traffic" / "corpus.json").read_text())
    a_ids, a_lens = gen.corpus(traffic, M30K, 2 ** 31 + 11)
    b_ids, b_lens = gen.corpus(traffic, M30K, 2 ** 31 + 11)
    c_ids, c_lens = gen.corpus(traffic, M30K, 2 ** 31 + 12)
    assert a_ids == b_ids and np.array_equal(a_lens, b_lens)
    assert a_ids != c_ids
    # every seed the same lengths, in another order
    assert np.array_equal(np.sort(a_lens), np.sort(c_lens))
    assert 4 <= a_lens.min() and a_lens.max() <= 32
    assert all(4 <= t < 8000 for s in a_ids[:50] for t in s)
    tr = json.loads((PKG / "traffic" / "train_pairs.json").read_text())
    tr = dict(tr, pairs=500)
    s1, t1 = gen.pairs(tr, M30K, 3)
    s2, t2 = gen.pairs(tr, M30K, 3)
    s3, t3 = gen.pairs(tr, M30K, 4)
    assert (s1, t1) == (s2, t2) and s1 != s3
    pairs1 = sorted((len(a), len(b)) for a, b in zip(s1, t1))
    assert pairs1 == sorted((len(a), len(b)) for a, b in zip(s3, t3))
    # a target's length follows its source's
    sl, tl = np.array(pairs1).T
    assert np.corrcoef(sl, tl)[0, 1] > 0.8
    assert np.abs(tl - sl).mean() < 3
    f1 = gen.features(6, 8, 0.5, 9, "cpu")
    assert torch.equal(f1, gen.features(6, 8, 0.5, 9, "cpu"))
    assert (f1 >= 0).all()
    assert gen.sub_seed(2 ** 31 + 5, "dropout", 31) < 2 ** 31


def test_weights_follow_the_ports_tree():
    """The benchmark's tree has the port's leaves, names and shapes."""
    from vag_nmt_tpu_torch.core.config import ModelConfig
    from vag_nmt_tpu_torch.models.model import init_params

    conf = tiny_conf()
    mine = weights.make(conf["model"], conf["weights"], 1, "cpu")
    fields = set(ModelConfig.__dataclass_fields__)
    theirs = init_params(ModelConfig(**{k: v for k, v in conf["model"].items()
                                        if k in fields}),
                         torch.Generator().manual_seed(0), device="cpu")
    assert weights.leaf_names(mine) == weights.leaf_names(theirs)
    assert [x.shape for x in weights.leaves_of(mine)] == \
        [x.shape for x in weights.leaves_of(theirs)]
    b_out = mine["decoder"]["readout"]["b_out"]
    assert b_out[0] == b_out[2] == conf["weights"]["banned_bias"]


def test_counts_at_m30k_shapes():
    """Hand-worked at E = 256, H = D = A = 512, C = 1024, V = 8000."""
    step = (2 * 256 * 1536 + 2 * 512 * 1536 + 2 * 512 * 512 + 2 * 13 * 512
            + 2 * 13 * 1024 + 2 * 1024 * 1536 + 2 * 512 * 1536
            + 2 * (256 * 256 + 512 * 256 + 1024 * 256) + 2 * 256 * 8000)
    assert step == 12_655_616 == counts.decode_step_flops(M30K, 13)
    enc = 2 * (2 * 13 * 256 * 1536 + 2 * 13 * 512 * 1536)
    prep = (enc + 2 * 13 * 1024 * 512 + 2 * 1024 * 512 + 2 * 2048 * 512
            + 2 * 13 * 1024 * 512 + 2 * 512 * 512 + 2 * 13 * 512
            + 2 * 13 * 1024 + 2 * 1024 * 512 + 2 * 1024 * 512)
    assert counts.prepare_flops(M30K, 13) == prep
    assert counts.decode_sentence_flops(M30K, 13, 14, 5) == prep + 70 * step
    # kernel 1 at 640 rows: 3xTF32 at 495 TFLOP/s is 0.0159 ms
    fl, nb = counts.readout_counts(M30K, 640, 1, "float32")
    assert fl == 2 * 640 * 256 * 8000
    assert counts.least_s(fl, nb, "float32") == pytest.approx(
        3 * fl / 495e12)
    assert 1e3 * counts.least_s(fl, nb, "float32") == pytest.approx(
        0.0159, abs=1e-4)
    # bf16: half the bytes, the bf16 rate
    fl2, nb2 = counts.readout_counts(M30K, 640, 1, "bfloat16")
    assert fl2 == fl and nb2 < nb
    assert counts.least_s(fl2, nb2, "bfloat16") == pytest.approx(fl / 989e12)
    # kernel 2 at (1024, 32): one direction's 2 * H * 3H a row-step
    fg, _ = counts.gru_fwd_counts(M30K, 1024 * 32, 1, "float32")
    assert fg == 2 * 1024 * 32 * 512 * 1536
    fb, _ = counts.gru_bwd_counts(M30K, 1024 * 32, 1, "bfloat16")
    assert fb == 2 * fg
    scan = (2 * 512 * 1536 + 2 * 512 * 512 + 2 * 13 * 512 + 2 * 13 * 1024
            + 2 * 1024 * 1536 + 2 * 512 * 1536 + 2 * 512 * 256
            + 2 * 1024 * 256)
    assert counts.dec_scan_step_flops(M30K, 13) == scan
    f4, _ = counts.dec_scan_fwd_counts(M30K, [(13, 14)] * 64, 1, "bfloat16")
    f5, _ = counts.dec_scan_bwd_counts(M30K, [(13, 14)] * 64, 1, "bfloat16")
    assert f4 == 64 * 14 * scan and f5 == 2 * f4
    batch = counts.train_batch_flops(M30K, [(13, 14)] * 64)
    assert batch == 64 * 3 * (prep + 14 * step) + 3 * 2 * 64 * 64 * 512


def test_trace_union_and_gaps():
    busy, gaps = trace._union([(0, 12), (5, 10), (18, 35), (50, 70)], 0, 100)
    assert busy == 12 + 17 + 20
    assert gaps == [(12, 18), (35, 50), (70, 100)]
    host = [(0, 100, "outer"), (10, 20, "inner"), (30, 60, "mid"),
            (40, 45, "deep")]
    got = dict(trace._attribute(gaps, host))
    assert got == pytest.approx({"outer": 30e-6, "deep": 15e-6,
                                 "inner": 6e-6})
    assert trace.kernel_s({"void readout_topk_kernel<5>(P)": 1.0,
                           "gru_fwd_persistent<8>": 2.0,
                           "dec_scan_fwd_tiles_kernel": 4.0,
                           "dec_scan_bwd_kernel": 8.0},
                          "dec_scan_fwd", "readout_topk") == 5.0


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_bench):
    """In a fresh interpreter (the test session's own has JAX loaded by
    the repository's conftest), a decode and a training run on the CPU,
    then every loaded module's top-level name, compared whole."""
    bench, root, pkg = tiny_bench
    code = f"""
import json, sys, time, torch
sys.path.insert(0, {str(ROOT)!r})
from pathlib import Path
from portbench import run, control, probe, faults
bench = json.loads(Path({str(root)!r}, "BENCHMARK.json").read_text())
for name in ("tiny.dec", "tiny.tr"):
    out = run.execute(bench, run.workload(bench, name), 3, 0.3, True,
                      torch.device("cpu"), time.perf_counter(),
                      root=Path({str(root)!r}), pkg=Path({str(pkg)!r}))
    assert out["correct"], out
print(json.dumps(run.forbidden_modules()))
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, env=cpu_env(), cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []
    names = ["jax", "jaxlib", "flax", "vag_nmt_tpu"]
    assert run.FORBIDDEN == tuple(names)
    # whole names: the port's name begins with the JAX package's
    assert "vag_nmt_tpu_torch".split(".")[0] not in names


def test_without_a_card_the_command_prints_no_result():
    res = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "m30k.decode",
         "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
        timeout=300, env=dict(cpu_env(), CUDA_VISIBLE_DEVICES=""),
        cwd=str(ROOT))
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.parametrize("group", ["model", "data", "train", "decode"])
def test_a_key_the_port_lacks_is_refused(group):
    """A misspelt or unknown key of a configuration file raises, so no
    file claims a size that the run does not use."""
    from portbench.drivers.common import port_config

    conf = tiny_conf()
    port_config(conf, 1)
    conf[group]["hiden_dim"] = 7
    with pytest.raises(KeyError, match="hiden_dim"):
        port_config(conf, 1)


def test_every_configuration_runs_as_its_file_states():
    """Every number of a configuration file's groups is the port's value,
    and its precision the port's dtypes."""
    from portbench.drivers.common import port_config

    bench = run.load_benchmark(ROOT)
    for c in bench["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        cfg = port_config(conf, 1)
        for group in ("model", "data", "train", "decode"):
            for k, v in conf[group].items():
                got = getattr(getattr(cfg, group), k)
                assert got == (tuple(v) if isinstance(v, list) else v), (
                    c["name"], group, k)
        assert cfg.decode.compute_dtype == conf["precision"]["decode"]
        assert cfg.model.compute_dtype == conf["precision"]["train"]
