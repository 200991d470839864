"""The benchmark's tests: CPU tests, and tests marked ``card`` that run
only where a CUDA card is (they skip elsewhere, deciding inside the test).

    python3 -m pytest portbench/tests --confcutdir=portbench -p no:cacheprovider
"""

import json
import os
import shutil
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips on a machine without one")


def tiny_conf(base: str = "m30k_ende_vag") -> dict:
    """A configuration file's content cut to a size the CPU runs in
    seconds (every width small, the vocabularies 300)."""
    conf = json.loads((PKG / "configs" / f"{base}.json").read_text())
    conf["model"].update(src_vocab_size=300, tgt_vocab_size=300, emb_dim=16,
                         hidden_dim=16, dec_hidden_dim=16, attn_dim=16,
                         shared_dim=16, img_feat_dim=32)
    conf["data"]["batch_size"] = 8
    conf["decode"]["decode_batch_size"] = 8
    conf["train"]["steps_per_dispatch"] = 2
    conf["precision"] = {"train": "float32", "decode": "float32"}
    return conf


@pytest.fixture
def tiny_bench(tmp_path):
    """A checkout-like tree holding a tiny configuration, a decode and a
    train traffic, their limits (the real cells' own) and the real
    metric readers: (bench, root, pkg)."""
    root = tmp_path / "root"
    pkg = root / "portbench"
    for d in ("configs", "traffic", "limits"):
        (pkg / d).mkdir(parents=True)
    shutil.copytree(PKG / "metrics", pkg / "metrics")
    (pkg / "configs" / "tiny.json").write_text(json.dumps(tiny_conf()))
    lens = {"dist": "normal", "mean": 6, "sd": 2, "min": 2, "max": 10}
    (pkg / "traffic" / "dec.json").write_text(json.dumps(
        {"kind": "decode", "sentences": 40, "src_len": lens,
         "check_sample": 12}))
    (pkg / "traffic" / "tr.json").write_text(json.dumps(
        {"kind": "train", "pairs": 300, "src_len": lens,
         "tgt_len": {"ratio": 1.0, "sd": 2.0, "min": 2, "max": 10}}))
    for cell, real in (("tiny.dec", "m30k.decode"),
                       ("tiny.tr", "m30k.train")):
        shutil.copy(PKG / "limits" / f"{real}.json",
                    pkg / "limits" / f"{cell}.json")
    bench = {
        "configs": [{"name": "tiny", "file": "portbench/configs/tiny.json"}],
        "workloads": [
            {"name": "tiny.dec", "config": "tiny", "traffic": "dec",
             "chips": 1},
            {"name": "tiny.tr", "config": "tiny", "traffic": "tr",
             "chips": 1}],
        "end_to_end": [
            {"name": "decode_sent_per_s", "unit": "sentences/s",
             "workloads": ["tiny.dec"]},
            {"name": "train_tok_per_s", "unit": "tokens/s",
             "workloads": ["tiny.tr"]},
            {"name": "setup_s", "unit": "s"}],
        "per_layer": [
            {"name": "decode.mfu", "unit": "%", "moves": "decode_sent_per_s"},
            {"name": "train.mfu", "unit": "%", "moves": "train_tok_per_s"},
            {"name": "train.single_step_share", "unit": "%",
             "moves": "train_tok_per_s", "workloads": ["tiny.tr"]}]}
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, root, pkg


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided here, at
    run time, never at import)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def cpu_env():
    """An environment for a subprocess of the harness on the CPU."""
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    return env
