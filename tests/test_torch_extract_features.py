"""PyTorch port, offline feature extraction (``data/extract_features.py``)
on the CPU.

- The architecture: a seeded state dict in torchvision's ``resnet50``
  format, its names and shapes written out here (320 entries, 25,557,032
  parameters with ``fc``), loads strictly into ``ResNet50``; one extra,
  one missing and one misshaped key each raise.
- The forward against an independent float64 numpy forward of the same
  state dict (im2col convolutions, eval BN, max pool, mean pool) on a
  seeded 2 x 3 x 64 x 64 input: within 1e-4 of the largest pool5 value
  (fp32 against fp64 through 53 convolutions).
- ``preprocess`` against torchvision's steps done by hand with PIL and
  numpy, bit for bit.
- ``extract_to_file`` against the JAX package's, both under the same
  monkeypatched forward (as ``tests/test_extract_features.py`` does): the
  same .npy bytes and sidecar, and the same refusal of a count mismatch
  before anything is written.
- The ``extract-features`` command on the CPU with weights found under
  ``TORCH_HOME``, and the ``FileNotFoundError`` without them.
No torchvision is needed anywhere (none is installed here)."""

import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import vag_nmt_tpu.data.extract_features as jef

from vag_nmt_tpu_torch import cli
from vag_nmt_tpu_torch.data import extract_features as ef
from vag_nmt_tpu_torch.data.features import load_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAYERS = ((64, 3), (128, 4), (256, 6), (512, 3))   # (width, bottlenecks)
BN_EPS = 1e-5
REL_TOL = 1e-4


def torchvision_shapes():
    """{name: shape} of torchvision's resnet50 state dict, in its order."""
    shapes = {}

    def conv(name, o, i, k):
        shapes[f"{name}.weight"] = (o, i, k, k)

    def bn(name, c):
        for s in ("weight", "bias", "running_mean", "running_var"):
            shapes[f"{name}.{s}"] = (c,)
        shapes[f"{name}.num_batches_tracked"] = ()

    conv("conv1", 64, 3, 7)
    bn("bn1", 64)
    in_ch = 64
    for li, (w, n) in enumerate(LAYERS, 1):
        for b in range(n):
            p = f"layer{li}.{b}"
            conv(f"{p}.conv1", w, in_ch, 1)
            bn(f"{p}.bn1", w)
            conv(f"{p}.conv2", w, w, 3)
            bn(f"{p}.bn2", w)
            conv(f"{p}.conv3", 4 * w, w, 1)
            bn(f"{p}.bn3", 4 * w)
            if b == 0:
                conv(f"{p}.downsample.0", 4 * w, in_ch, 1)
                bn(f"{p}.downsample.1", 4 * w)
            in_ch = 4 * w
    shapes["fc.weight"] = (1000, 2048)
    shapes["fc.bias"] = (1000,)
    return shapes


def seeded_state(seed=0):
    """Random weights in torchvision's format: He-normal convolutions, BN
    scales near 1 with positive running variances, small shifts."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in torchvision_shapes().items():
        if name.endswith("num_batches_tracked"):
            out[name] = torch.tensor(0, dtype=torch.int64)
        elif len(shape) == 4:
            fan_in = shape[1] * shape[2] * shape[3]
            out[name] = torch.randn(shape, generator=g) * (2.0 / fan_in) ** 0.5
        elif name.endswith(("running_var", "bn1.weight", "bn2.weight",
                            "bn3.weight", "downsample.1.weight")) \
                and not name.startswith("fc"):
            out[name] = 0.5 + torch.rand(shape, generator=g)
        else:
            out[name] = 0.1 * torch.randn(shape, generator=g)
    return out


@pytest.fixture(scope="module")
def state():
    return seeded_state()


def test_torchvision_format_loads_strictly(state):
    assert len(state) == 320
    n_params = sum(v.numel() for k, v in state.items()
                   if not k.endswith(("running_mean", "running_var",
                                      "num_batches_tracked")))
    assert n_params == 25_557_032
    model = ef.resnet50_from_state(state)
    assert not model.training
    assert set(model.state_dict()) == set(state) - {"fc.weight", "fc.bias"}
    for k, v in model.state_dict().items():
        assert torch.equal(v, state[k]), k


@pytest.mark.parametrize("fault", ["extra", "missing", "misshaped"])
def test_a_faulty_state_dict_raises(state, fault):
    bad = dict(state)
    if fault == "extra":
        bad["layer1.0.conv4.weight"] = torch.zeros(1)
    elif fault == "missing":
        del bad["layer3.2.bn2.running_var"]
    else:
        bad["layer2.0.downsample.0.weight"] = torch.zeros(512, 256, 1, 2)
    with pytest.raises(RuntimeError, match="state_dict"):
        ef.resnet50_from_state(bad)


# ---------------------------------------------------------------------------
# Forward against numpy float64
# ---------------------------------------------------------------------------

def _conv(x, w, stride=1, pad=0):
    """im2col convolution: x (N, C, H, W), w (O, C, k, k)."""
    k = w.shape[2]
    if pad:
        x = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    win = np.lib.stride_tricks.sliding_window_view(x, (k, k), axis=(2, 3))
    win = win[:, :, ::stride, ::stride]             # (N, C, Ho, Wo, k, k)
    n, c, ho, wo = win.shape[:4]
    cols = win.transpose(0, 2, 3, 1, 4, 5).reshape(n * ho * wo, c * k * k)
    out = cols @ w.reshape(w.shape[0], -1).T
    return out.reshape(n, ho, wo, -1).transpose(0, 3, 1, 2)


def _bn(x, sd, name):
    g, b, m, v = (sd[f"{name}.{s}"][None, :, None, None]
                  for s in ("weight", "bias", "running_mean", "running_var"))
    return (x - m) / np.sqrt(v + BN_EPS) * g + b


def _maxpool(x):
    x = np.pad(x, ((0, 0), (0, 0), (1, 1), (1, 1)), constant_values=-np.inf)
    win = np.lib.stride_tricks.sliding_window_view(x, (3, 3), axis=(2, 3))
    return win[:, :, ::2, ::2].max(axis=(4, 5))


def numpy_pool5(sd, x):
    sd = {k: v.double().numpy() for k, v in sd.items()}
    relu = lambda a: np.maximum(a, 0.0)     # noqa: E731
    x = relu(_bn(_conv(x, sd["conv1.weight"], 2, 3), sd, "bn1"))
    x = _maxpool(x)
    for li, (_, n) in enumerate(LAYERS, 1):
        for b in range(n):
            p = f"layer{li}.{b}"
            s = 2 if (b == 0 and li > 1) else 1
            y = relu(_bn(_conv(x, sd[f"{p}.conv1.weight"]), sd, f"{p}.bn1"))
            y = relu(_bn(_conv(y, sd[f"{p}.conv2.weight"], s, 1), sd,
                         f"{p}.bn2"))
            y = _bn(_conv(y, sd[f"{p}.conv3.weight"]), sd, f"{p}.bn3")
            if b == 0:
                x = _bn(_conv(x, sd[f"{p}.downsample.0.weight"], s), sd,
                        f"{p}.downsample.1")
            x = relu(y + x)
    return x.mean(axis=(2, 3))


def test_forward_matches_a_numpy_float64_forward(state):
    x = np.random.RandomState(0).randn(2, 3, 64, 64).astype(np.float32)
    ref = numpy_pool5(state, x.astype(np.float64))
    with torch.inference_mode():
        got = ef.resnet50_from_state(state)(torch.from_numpy(x)).numpy()
    assert got.shape == (2, ef.POOL5_DIM) and got.dtype == np.float32
    scale = np.abs(ref).max()
    assert scale > 0.1 and (ref > 0).mean() > 0.5   # a live network
    np.testing.assert_allclose(got, ref, rtol=0, atol=REL_TOL * scale)


# ---------------------------------------------------------------------------
# preprocess
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wh,resized,offsets", [
    ((500, 375), (341, 256), (58, 16)),      # (left, top)
    ((375, 500), (256, 341), (16, 58)),
])
def test_preprocess_matches_the_steps_by_hand(wh, resized, offsets):
    from PIL import Image

    rng = np.random.RandomState(sum(wh))
    img = Image.fromarray(rng.randint(0, 256, (wh[1], wh[0], 3), np.uint8))
    got = ef.preprocess(img).numpy()
    r = img.resize(resized, Image.BILINEAR)
    left, top = offsets
    c = np.asarray(r.crop((left, top, left + 224, top + 224)), np.uint8)
    x = c.transpose(2, 0, 1).astype(np.float32) / np.float32(255)
    mean = np.array([0.485, 0.456, 0.406], np.float32)[:, None, None]
    std = np.array([0.229, 0.224, 0.225], np.float32)[:, None, None]
    assert got.shape == (3, 224, 224) and got.dtype == np.float32
    np.testing.assert_array_equal(got, (x - mean) / std)


# ---------------------------------------------------------------------------
# extract_to_file against the JAX package's
# ---------------------------------------------------------------------------

def _write_images(d, n, size=(40, 30)):
    from PIL import Image

    d.mkdir()
    rng = np.random.RandomState(n)
    names = [f"img_{i}.png" for i in range(n)]
    for nm in names:
        Image.fromarray(rng.randint(0, 256, (size[1], size[0], 3),
                                    np.uint8)).save(d / nm)
    return names


@pytest.fixture()
def image_setup(tmp_path, monkeypatch):
    names = _write_images(tmp_path / "imgs", 5)
    (tmp_path / "images.txt").write_text("\n".join(names) + "\n")
    lines = [f"sentence {i}" for i in range(5)]
    (tmp_path / "corpus.en").write_text("\n".join(lines) + "\n")
    seen = {}

    def fake_extract(paths, batch_size=32, device="cpu", **_):
        seen.setdefault("paths", []).append(list(paths))
        out = np.zeros((len(paths), 8), np.float32)
        for r, p in enumerate(paths):
            out[r] = zlib.crc32(os.path.basename(p).encode()) % 1000
        return out

    monkeypatch.setattr(ef, "extract_resnet50_pool5", fake_extract)
    monkeypatch.setattr(jef, "extract_resnet50_pool5", fake_extract)
    return tmp_path, names, lines, seen


def test_extract_to_file_writes_what_the_jax_package_writes(image_setup):
    tmp, names, lines, seen = image_setup
    args = (str(tmp / "imgs"), str(tmp / "images.txt"))
    ef.extract_to_file(*args, str(tmp / "port.npy"),
                       corpus_path=str(tmp / "corpus.en"), device="cpu")
    jef.extract_to_file(*args, str(tmp / "jax.npy"),
                        corpus_path=str(tmp / "corpus.en"))
    assert seen["paths"][0] == seen["paths"][1]
    assert [os.path.basename(p) for p in seen["paths"][0]] == names
    for suffix in ("", ".align.json"):
        assert (tmp / f"port.npy{suffix}").read_bytes() == \
            (tmp / f"jax.npy{suffix}").read_bytes()
    feats = load_features(str(tmp / "port.npy"), expected_rows=5,
                          corpus_lines=lines)
    assert feats.shape == (5, 8)
    with pytest.raises(ValueError):
        load_features(str(tmp / "port.npy"), expected_rows=5,
                      corpus_lines=lines[::-1])


def test_extract_to_file_rejects_a_count_mismatch_before_writing(image_setup):
    tmp, _, _, seen = image_setup
    (tmp / "short.en").write_text("only one line\n")
    for mod, name in ((ef, "port.npy"), (jef, "jax.npy")):
        with pytest.raises(ValueError, match="alignment"):
            mod.extract_to_file(str(tmp / "imgs"), str(tmp / "images.txt"),
                                str(tmp / name),
                                corpus_path=str(tmp / "short.en"))
        assert not (tmp / name).exists()
    assert "paths" not in seen


# ---------------------------------------------------------------------------
# The command
# ---------------------------------------------------------------------------

def test_extract_features_command_on_the_cpu(tmp_path, state):
    names = _write_images(tmp_path / "imgs", 5)
    (tmp_path / "images.txt").write_text("\n".join(names) + "\n")
    lines = [f"a caption {i}" for i in range(5)]
    (tmp_path / "corpus.en").write_text("\n".join(lines) + "\n")
    home = tmp_path / "torch_home"
    ckpt = home / "hub" / "checkpoints"
    ckpt.mkdir(parents=True)
    torch.save(state, ckpt / ef.WEIGHTS_FILE)
    out = tmp_path / "feats.npy"
    env = dict(os.environ, PYTHONPATH=REPO, TORCH_HOME=str(home),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "vag_nmt_tpu_torch", "extract-features",
         "--image-dir", str(tmp_path / "imgs"),
         "--image-list", str(tmp_path / "images.txt"),
         "--corpus", str(tmp_path / "corpus.en"), "--out", str(out),
         "--batch-size", "2", "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"features -> {out}" in r.stdout
    feats = load_features(str(out), expected_rows=5, corpus_lines=lines)
    assert feats.shape == (5, 2048) and feats.dtype == np.float32
    assert json.loads((tmp_path / "feats.npy.align.json").read_text())[
        "rows"] == 5
    direct = ef.extract_resnet50_pool5(
        [str(tmp_path / "imgs" / n) for n in names], batch_size=5,
        device="cpu", weights=state)
    np.testing.assert_allclose(np.asarray(feats), direct, rtol=0,
                               atol=1e-5 * np.abs(direct).max())


def test_missing_weights_raise_file_not_found(tmp_path, monkeypatch):
    names = _write_images(tmp_path / "imgs", 2)
    (tmp_path / "images.txt").write_text("\n".join(names) + "\n")
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty_home"))
    assert ef.default_weights_path() == str(
        tmp_path / "empty_home" / "hub" / "checkpoints" / ef.WEIGHTS_FILE)
    with pytest.raises(FileNotFoundError, match="resnet50-0676ba61.pth"):
        cli.main(["extract-features", "--image-dir", str(tmp_path / "imgs"),
                  "--image-list", str(tmp_path / "images.txt"),
                  "--out", str(tmp_path / "f.npy"), "--device", "cpu"])
    assert not (tmp_path / "f.npy").exists()
    with pytest.raises(FileNotFoundError, match="does not download"):
        ef.load_resnet50(tmp_path / "nowhere.pth")


def test_the_new_modules_import_no_jax_no_torchvision_and_nothing_of_native():
    """The extraction, BPE and the command line load with JAX, torchvision
    and the JAX package blocked, and no native BPE library (the JAX
    package's native/) comes into the process."""
    code = (
        "import sys\n"
        "for blocked in ('jax', 'jaxlib', 'torchvision', 'vag_nmt_tpu'):\n"
        "    sys.modules[blocked] = None\n"
        "import vag_nmt_tpu_torch.data.extract_features as ef\n"
        "import vag_nmt_tpu_torch.data.bpe as bpe\n"
        "import vag_nmt_tpu_torch.cli\n"
        "m = [('a', 'b'), ('ab', 'c</w>')]\n"
        "print(bpe.BPE(m).encode_line('abc ab'), ef.ResNet50().conv1.stride)\n"
        "print(sorted({ln.split()[-1] for ln in open('/proc/self/maps')\n"
        "              if 'bpe_apply' in ln}))\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines() == ["['abc', 'a@@', 'b'] (2, 2)", "[]"]
