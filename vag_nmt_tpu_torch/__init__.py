"""PyTorch/CUDA port of vag_nmt_tpu (Visual Attention Grounding NMT).

The layout mirrors the JAX package, so each counterpart is found by name.
Plain tensor code is PyTorch; the TPU kernels on the beam-decode, serving
and training paths are hand-written CUDA kernels for Hopper (``csrc/``),
built with ``nvcc`` at first use. The package imports torch, numpy and the
standard library only.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from vag_nmt_tpu_torch.core.config import Config, ModelConfig, preset
from vag_nmt_tpu_torch.decode.beam import (
    BeamResult,
    beam_search,
    beam_search_streaming,
)
from vag_nmt_tpu_torch.decode.greedy import GreedyResult, greedy_decode
from vag_nmt_tpu_torch.decode.serve import Translator
from vag_nmt_tpu_torch.decode.translate import build_img_table, translate_corpus
from vag_nmt_tpu_torch.models.model import (
    DecodeState,
    init_params,
    loss_fn,
    params_from_numpy,
    prepare_decode,
)
from vag_nmt_tpu_torch.train.loop import train_loop
from vag_nmt_tpu_torch.train.state import TrainState, create_train_state
from vag_nmt_tpu_torch.train.step import make_train_step

__all__ = ["BeamResult", "Config", "DecodeState", "GreedyResult",
           "ModelConfig", "TrainState", "Translator", "beam_search",
           "beam_search_streaming", "build_img_table", "create_train_state",
           "greedy_decode", "init_params", "loss_fn", "make_train_step",
           "params_from_numpy", "prepare_decode", "preset", "train_loop",
           "translate_corpus"]
