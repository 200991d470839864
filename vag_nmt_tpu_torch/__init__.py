"""PyTorch/CUDA port of vag_nmt_tpu (Visual Attention Grounding NMT).

The layout mirrors the JAX package, so each counterpart is found by name.
Plain tensor code is PyTorch; the TPU kernels on the beam-decode path are
hand-written CUDA kernels for Hopper (``csrc/``), built with ``nvcc`` at
first use. The package imports torch, numpy and the standard library only.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from vag_nmt_tpu_torch.core.config import Config, ModelConfig, preset
from vag_nmt_tpu_torch.decode.beam import BeamResult, beam_search
from vag_nmt_tpu_torch.decode.translate import build_img_table, translate_corpus
from vag_nmt_tpu_torch.models.model import (
    DecodeState,
    init_params,
    params_from_numpy,
    prepare_decode,
)

__all__ = ["BeamResult", "Config", "DecodeState", "ModelConfig",
           "beam_search", "build_img_table", "init_params",
           "params_from_numpy", "prepare_decode", "preset",
           "translate_corpus"]
