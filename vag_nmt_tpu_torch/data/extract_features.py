"""Offline image-feature extraction (counterpart of the JAX package's
``data/extract_features.py``): ResNet-50 pool5 (the global average pool,
2048-d) of each image, one row per corpus line, saved as .npy with the
alignment sidecar that ``data/features.load_features`` checks.

The network is the port's own ``ResNet50``: torchvision's architecture and
parameter names ("V1.5": the stride on each bottleneck's 3x3 conv), so a
torchvision state dict loads into it strictly, and no torchvision is
needed. Its weights default to the file torchvision's ``IMAGENET1K_V1``
reads once it is cached, ``<torch.hub.get_dir()>/checkpoints/
resnet50-0676ba61.pth`` (``TORCH_HOME`` moves it); the port never
downloads it. ``preprocess`` is torchvision's ``Resize(256)``,
``CenterCrop(224)``, ``ToTensor`` and ``Normalize`` with PIL and torch.

    python -m vag_nmt_tpu_torch extract-features \\
        --image-dir imgs/ --image-list train_images.txt \\
        --corpus train.en --out train_features.npy

where the image list has one image filename per corpus line. The forward
runs on the card unless ``--device cpu``, in fp32 (TF32 off)."""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch
from torch import nn

from vag_nmt_tpu_torch.core.device import DeviceLike, resolve_device

WEIGHTS_FILE = "resnet50-0676ba61.pth"
MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
RESIZE, CROP = 256, 224
POOL5_DIM = 2048

Weights = Union[None, str, os.PathLike, Dict[str, torch.Tensor]]


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride here) -> 1x1 x4, each with eval BN, plus the
    shortcut (``downsample``: 1x1 conv + BN where the shape changes)."""

    expansion = 4

    def __init__(self, in_ch: int, width: int, stride: int = 1):
        super().__init__()
        out_ch = width * self.expansion
        self.conv1 = nn.Conv2d(in_ch, width, 1, bias=False)
        self.bn1 = nn.BatchNorm2d(width)
        self.conv2 = nn.Conv2d(width, width, 3, stride=stride, padding=1,
                               bias=False)
        self.bn2 = nn.BatchNorm2d(width)
        self.conv3 = nn.Conv2d(width, out_ch, 1, bias=False)
        self.bn3 = nn.BatchNorm2d(out_ch)
        self.relu = nn.ReLU(inplace=True)
        self.downsample = None
        if stride != 1 or in_ch != out_ch:
            self.downsample = nn.Sequential(
                nn.Conv2d(in_ch, out_ch, 1, stride=stride, bias=False),
                nn.BatchNorm2d(out_ch))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idt = x if self.downsample is None else self.downsample(x)
        y = self.relu(self.bn1(self.conv1(x)))
        y = self.relu(self.bn2(self.conv2(y)))
        return self.relu(self.bn3(self.conv3(y)) + idt)


class ResNet50(nn.Module):
    """torchvision's ``resnet50`` up to its average pool: forward (N, 3, H,
    W) -> pool5 (N, 2048). No ``fc`` (the extraction replaces it by the
    identity)."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = nn.BatchNorm2d(64)
        self.relu = nn.ReLU(inplace=True)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        in_ch = 64
        for i, (width, blocks) in enumerate(((64, 3), (128, 4), (256, 6),
                                             (512, 3))):
            stride = 1 if i == 0 else 2
            layer = []
            for b in range(blocks):
                layer.append(Bottleneck(in_ch, width, stride if b == 0 else 1))
                in_ch = width * Bottleneck.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*layer))
        self.avgpool = nn.AdaptiveAvgPool2d((1, 1))
        self.eval()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.maxpool(self.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        return torch.flatten(self.avgpool(x), 1)


def default_weights_path() -> str:
    """Where torchvision caches ``IMAGENET1K_V1``'s ResNet-50 weights."""
    return os.path.join(torch.hub.get_dir(), "checkpoints", WEIGHTS_FILE)


def resnet50_from_state(state: Dict[str, torch.Tensor]) -> ResNet50:
    """A ResNet50 (eval mode, on the CPU) holding torchvision's state dict
    ``state``; strict: a missing, extra or misshaped key raises. ``fc``'s
    two entries are dropped."""
    state = {k: v for k, v in state.items() if k not in ("fc.weight", "fc.bias")}
    model = ResNet50()
    model.load_state_dict(state, strict=True)
    return model.eval()


def load_resnet50(path: Optional[Union[str, os.PathLike]] = None) -> ResNet50:
    """ResNet50 with the weights at ``path`` (default:
    ``default_weights_path()``); FileNotFoundError where the file is not
    there: the port does not download it."""
    path = os.fspath(path) if path is not None else default_weights_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"ResNet-50 weights not found at {path}; the port does not "
            f"download them: put torchvision's {WEIGHTS_FILE} (IMAGENET1K_V1) "
            f"there, or set TORCH_HOME to the directory whose "
            f"hub/checkpoints/ holds it")
    return resnet50_from_state(torch.load(path, map_location="cpu",
                                          weights_only=True))


def preprocess(image) -> torch.Tensor:
    """A PIL RGB image -> the (3, 224, 224) float32 input: the short side
    resized to 256 (bilinear), the centre 224 x 224 cropped, /255, then the
    ImageNet mean and std, as torchvision's transforms do it."""
    from PIL import Image

    w, h = image.size
    short, long = (w, h) if w <= h else (h, w)
    new_short, new_long = RESIZE, int(RESIZE * long / short)
    size = (new_short, new_long) if w <= h else (new_long, new_short)
    if size != (w, h):
        image = image.resize(size, Image.BILINEAR)
    w, h = image.size
    top = int(round((h - CROP) / 2.0))
    left = int(round((w - CROP) / 2.0))
    image = image.crop((left, top, left + CROP, top + CROP))
    x = torch.from_numpy(np.array(image, np.uint8, copy=True))
    x = x.permute(2, 0, 1).contiguous().to(torch.float32).div(255)
    mean = torch.tensor(MEAN, dtype=torch.float32)[:, None, None]
    std = torch.tensor(STD, dtype=torch.float32)[:, None, None]
    return x.sub(mean).div(std)


def extract_resnet50_pool5(image_paths: List[str], batch_size: int = 32,
                           device: DeviceLike = None,
                           weights: Weights = None) -> np.ndarray:
    """(N, 2048) float32 pool5 features in ``image_paths`` order, on the
    card unless ``device="cpu"``. weights: torchvision's state dict, or
    the path of a file holding one; None is ``load_resnet50()``'s file."""
    from PIL import Image

    dev = resolve_device(device)
    if isinstance(weights, dict):
        model = resnet50_from_state(weights)
    else:
        model = load_resnet50(weights)
    model = model.to(dev)
    feats = np.zeros((len(image_paths), POOL5_DIM), np.float32)
    with torch.inference_mode():
        for i in range(0, len(image_paths), batch_size):
            chunk = image_paths[i: i + batch_size]
            imgs = []
            for p in chunk:
                with Image.open(p) as im:
                    imgs.append(preprocess(im.convert("RGB")))
            out = model(torch.stack(imgs).to(dev))
            feats[i: i + len(chunk)] = out.cpu().numpy()
    return feats


def extract_to_file(image_dir: str, image_list: str, out_path: str,
                    corpus_path: Optional[str] = None, batch_size: int = 32,
                    device: DeviceLike = None) -> None:
    """Features of the images named in ``image_list`` (one a line, under
    ``image_dir``), in list order, saved to ``out_path``; with
    ``corpus_path``, the alignment sidecar too, and a ValueError before
    anything is written where the list and the corpus differ in length."""
    from vag_nmt_tpu_torch.data.features import save_features

    with open(image_list, encoding="utf-8") as f:
        names = [ln.strip() for ln in f if ln.strip()]
    paths = [os.path.join(image_dir, n) for n in names]
    corpus_lines = None
    if corpus_path:
        with open(corpus_path, encoding="utf-8") as f:
            corpus_lines = [ln.rstrip("\n") for ln in f]
        if len(corpus_lines) != len(paths):
            raise ValueError(
                f"image list has {len(paths)} entries, corpus "
                f"{len(corpus_lines)} lines — alignment would be corrupt")
    feats = extract_resnet50_pool5(paths, batch_size=batch_size, device=device)
    save_features(out_path, feats, corpus_lines=corpus_lines)
