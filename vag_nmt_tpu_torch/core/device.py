"""Device and kernel-implementation resolution.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"`` they raise. Nothing falls back
to the CPU quietly. On a CUDA device fp32 means fp32: TF32 is switched off
for both matmuls and cuDNN."""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]

# JAX-side impl names (ModelConfig.gru_impl, fused_readout_topk's impl=)
# mapped onto the port's names.
_IMPL_ALIASES = {"pallas": "kernel", "xla": "plain"}


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None means the card. Raises when CUDA is asked for (or defaulted to)
    and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def resolve_impl(impl: str, tensor: torch.Tensor) -> str:
    """"auto" | "kernel" | "plain" (or the JAX names "pallas" / "xla") ->
    "kernel" | "plain" for this tensor. "auto" picks the kernel for CUDA
    tensors and the plain version for CPU tensors; "kernel" on a CPU tensor
    raises."""
    impl = _IMPL_ALIASES.get(impl, impl)
    if impl == "auto":
        return "kernel" if tensor.is_cuda else "plain"
    if impl == "kernel":
        if not tensor.is_cuda:
            raise ValueError("impl='kernel' needs CUDA tensors; the CUDA "
                             "kernels have no CPU mode")
        return impl
    if impl == "plain":
        return impl
    raise ValueError(f"unknown impl {impl!r}")


def same_device(expected: torch.device, t: torch.Tensor, what: str) -> None:
    if t.device.type != expected.type:
        raise ValueError(f"{what} lies on {t.device}, expected {expected}")


def check_kernel_arg(x: torch.Tensor, dtype: torch.dtype, shape, what: str) -> None:
    """A kernel wrapper's argument check: a contiguous CUDA tensor of the
    given dtype and shape, or ValueError."""
    if x.dtype != dtype or not x.is_cuda or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} CUDA tensor "
                         f"(got {x.dtype} on {x.device})")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{what} has shape {tuple(x.shape)}, expected "
                         f"{tuple(shape)}")
