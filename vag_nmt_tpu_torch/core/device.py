"""Device and kernel-implementation resolution.

Entry points run on the card unless the caller asks for the CPU: with no
CUDA device and no explicit ``device="cpu"`` they raise. Nothing falls back
to the CPU quietly. On a CUDA device fp32 means fp32: TF32 is switched off
for both matmuls and cuDNN."""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DeviceLike = Union[None, str, torch.device]

# JAX-side impl names (ModelConfig.gru_impl, fused_readout_topk's impl=)
# mapped onto the port's names.
_IMPL_ALIASES = {"pallas": "kernel", "xla": "plain"}


def world_env() -> Optional[dict]:
    """This process's place in a launch of several processes, from the
    variables ``python -m torch.distributed.run`` sets: {rank, world,
    local_rank, local_world}; None outside such a launch (WORLD_SIZE unset
    or 1)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    rank = int(os.environ["RANK"])
    return {"rank": rank, "world": world,
            "local_rank": int(os.environ.get("LOCAL_RANK", rank)),
            "local_world": int(os.environ.get("LOCAL_WORLD_SIZE", world))}


def _rank_card() -> Optional[int]:
    """The card of this rank of a launch: ``LOCAL_RANK`` where the host
    has a card for every local rank, else 0, shared. None outside a
    launch."""
    env = world_env()
    if env is None:
        return None
    return (env["local_rank"]
            if torch.cuda.device_count() >= env["local_world"] else 0)


def resolve_device(device: DeviceLike = None) -> torch.device:
    """None means the card: under a launch of several processes this
    rank's card (``cuda:LOCAL_RANK``, or ``cuda:0`` where the ranks share
    one), made the current device. Raises when CUDA is asked for (or
    defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the CPU")
        if dev.index is None:
            card = _rank_card()
            if card is not None:
                dev = torch.device("cuda", card)
                torch.cuda.set_device(dev)
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
