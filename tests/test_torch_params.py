"""PyTorch port: config copy, parameter init, the weight bridge from the JAX
parameter tree, and the rule that the port imports nothing of JAX.

All on the CPU. Leaves are compared exactly: the bridge copies values."""

import functools
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from vag_nmt_tpu.core.config import preset as jax_preset
from vag_nmt_tpu.models import init_params as jax_init_params

import vag_nmt_tpu_torch as vt
from vag_nmt_tpu_torch.core.config import PRESETS
from vag_nmt_tpu_torch.core.device import resolve_device, resolve_impl

# One intra-op thread: the suite runs several test processes at once, and
# PyTorch's default pool of one thread per core oversubscribes the CPU.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flat(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, tree


@functools.lru_cache(maxsize=None)
def _jax_numpy_params(name, seed=1):
    return jax.device_get(jax_init_params(jax.random.key(seed),
                                          jax_preset(name).model))


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_config_copy_matches_jax(name):
    assert vt.preset(name).to_dict() == jax_preset(name).to_dict()


@pytest.mark.parametrize("name", ["toy", "m30k_ende_vag"])
def test_bridge_round_trips_jax_tree(name):
    jp = _jax_numpy_params(name)
    p = vt.params_from_numpy(jp, vt.preset(name).model, device="cpu")
    fj, fp = dict(_flat(jp)), dict(_flat(p))
    assert sorted(fj) == sorted(fp)
    for k, v in fj.items():
        assert fp[k].dtype == torch.float32
        np.testing.assert_array_equal(fp[k].numpy(), np.asarray(v), err_msg=k)


def test_bridge_is_strict_about_paths_and_shapes():
    m = vt.preset("toy").model
    good = _jax_numpy_params("toy")

    missing = jax.tree.map(lambda x: x, good)
    del missing["decoder"]["readout"]["b_out"]
    with pytest.raises(ValueError, match="missing"):
        vt.params_from_numpy(missing, m, device="cpu")

    extra = jax.tree.map(lambda x: x, good)
    extra["init"]["unused"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unexpected"):
        vt.params_from_numpy(extra, m, device="cpu")

    shape = jax.tree.map(lambda x: x, good)
    shape["decoder"]["attn"]["va"] = np.zeros((32, 1), np.float32)
    with pytest.raises(ValueError, match="shape"):
        vt.params_from_numpy(shape, m, device="cpu")

    layers = jax.tree.map(lambda x: x, good)
    layers["encoder"]["layers"] = layers["encoder"]["layers"] * 2
    with pytest.raises(ValueError, match="list"):
        vt.params_from_numpy(layers, m, device="cpu")


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_port_init_params_tree_matches_jax(name):
    want = jax.eval_shape(
        lambda: jax_init_params(jax.random.key(0), jax_preset(name).model))
    got = vt.init_params(vt.preset(name).model,
                         torch.Generator().manual_seed(0), device="cpu")
    fw = {k: tuple(v.shape) for k, v in _flat(want)}
    fg = {k: tuple(v.shape) for k, v in _flat(got)}
    assert fw == fg
    assert all(v.dtype == torch.float32 for _, v in _flat(got))


def test_port_init_params_distributions():
    """Same distributions as the JAX init (not the same numbers): orthogonal
    per-gate recurrent blocks, zero biases, embeddings at std dim**-0.5,
    Glorot-uniform matrices inside their limit."""
    m = vt.preset("m30k_ende_vag").model
    p = vt.init_params(m, torch.Generator().manual_seed(3), device="cpu")
    H = m.hidden_dim
    uh = p["encoder"]["layers"][0]["fwd"]["uh"]
    for g in range(3):
        blk = uh[:, g * H:(g + 1) * H]
        np.testing.assert_allclose((blk.T @ blk).numpy(), np.eye(H), atol=1e-4)
    assert float(p["decoder"]["readout"]["b_out"].abs().max()) == 0.0
    table = p["encoder"]["embed"]["table"]
    assert abs(float(table.std()) - m.emb_dim ** -0.5) < 0.01 * m.emb_dim ** -0.5
    w = p["decoder"]["readout"]["w_out"]
    lim = (6.0 / sum(w.shape)) ** 0.5
    assert float(w.abs().max()) <= lim
    assert float(w.abs().max()) > 0.99 * lim


def test_port_params_round_trip_through_numpy():
    m = vt.preset("toy").model
    p = vt.init_params(m, torch.Generator().manual_seed(0), device="cpu")
    tree = jax.tree.map(lambda x: x.numpy(), p)
    back = vt.params_from_numpy(tree, m, device="cpu")
    for (k, a), (_, b) in zip(_flat(p), _flat(back)):
        assert torch.equal(a, b), k


def test_port_imports_without_jax():
    """Importing every module of the port with jax blocked succeeds and
    loads no module of the JAX package."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import vag_nmt_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules\n"
        "       if m == 'vag_nmt_tpu' or m.startswith('vag_nmt_tpu.')\n"
        "       or m == 'jax' and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_sources_do_not_import_jax():
    pat = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|vag_nmt_tpu)\b",
                     re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "vag_nmt_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pat.search(open(f).read())]
    assert not offenders


def test_default_device_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = vt.preset("toy")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        vt.init_params(cfg.model, torch.Generator().manual_seed(0))
    p = vt.init_params(cfg.model, torch.Generator().manual_seed(0),
                       device="cpu")
    batch = {"src": np.full((2, 4), 5), "src_mask": np.ones((2, 4)),
             "img": np.zeros((2, cfg.model.img_feat_dim), np.float32)}
    with pytest.raises(RuntimeError):
        vt.prepare_decode(p, cfg.model, batch)
    state = vt.prepare_decode(p, cfg.model, batch, device="cpu")
    with pytest.raises(RuntimeError):
        vt.beam_search(p, cfg.model, state, beam_size=2, max_len=3)
    with pytest.raises(RuntimeError):
        vt.translate_corpus(p, cfg, [], None)


def test_impl_resolution():
    cpu = torch.zeros(1)
    assert resolve_impl("auto", cpu) == "plain"
    assert resolve_impl("xla", cpu) == "plain"
    assert resolve_impl("plain", cpu) == "plain"
    for impl in ("kernel", "pallas"):
        with pytest.raises(ValueError, match="CUDA"):
            resolve_impl(impl, cpu)
    with pytest.raises(ValueError, match="unknown"):
        resolve_impl("fast", cpu)
