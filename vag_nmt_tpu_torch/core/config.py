"""Typed configuration tree + named presets (own copy of the JAX package's
``core/config.py``: same dataclasses, field names, defaults and presets, so a
``Config`` serialized by either package loads in the other)."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, Tuple

# Special token ids, fixed across the framework.
PAD_ID = 0
UNK_ID = 1
SOS_ID = 2
EOS_ID = 3
SPECIALS = ("<pad>", "<unk>", "<sos>", "<eos>")


@dataclass(frozen=True)
class ModelConfig:
    """Architecture of the (VAG-)NMT model."""

    src_vocab_size: int = 8000
    tgt_vocab_size: int = 8000
    emb_dim: int = 256
    hidden_dim: int = 256           # encoder hidden per direction; ctx dim = 2*hidden
    dec_hidden_dim: int = 256       # decoder GRU state size
    attn_dim: int = 256             # Bahdanau MLP attention inner dim
    enc_layers: int = 1
    dropout: float = 0.3
    tied_readout_embedding: bool = False

    multimodal: bool = False
    img_feat_dim: int = 2048        # ResNet-50 pool5
    shared_dim: int = 512           # shared visual-text embedding space
    vse_margin: float = 0.1
    vse_weight: float = 0.25
    vse_hard_negatives: bool = False

    compute_dtype: str = "float32"

    # Encoder GRU scan: "auto" (hand-written kernel for CUDA tensors, plain
    # torch for CPU tensors), "pallas" (force the kernel), "xla" (force the
    # plain version). The JAX names are kept so configs load unchanged;
    # ops/gru.py maps them to "kernel" / "plain".
    gru_impl: str = "auto"
    dec_scan_impl: str = "auto"

    @property
    def ctx_dim(self) -> int:
        return 2 * self.hidden_dim


@dataclass(frozen=True)
class DataConfig:
    data_dir: str = ""
    dataset: str = "multi30k"       # "multi30k" | "ikea" | "toy"
    src_lang: str = "en"
    tgt_lang: str = "de"
    bpe_merges: int = 10000
    vocab_min_freq: int = 1
    max_src_len: int = 64
    max_tgt_len: int = 64
    batch_size: int = 64
    length_buckets: Tuple[int, ...] = (8, 12, 16, 24, 32, 48, 64)
    shuffle_seed: int = 0
    feature_file: str = ""


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 1e-3
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    grad_clip_norm: float = 1.0
    lr_decay_factor: float = 0.5
    lr_decay_patience: int = 3
    early_stop_patience: int = 10
    max_epochs: int = 100
    eval_every_steps: int = 1000
    log_every_steps: int = 100
    steps_per_dispatch: int = 8
    seed: int = 1234
    checkpoint_dir: str = "checkpoints"
    resume: bool = False


@dataclass(frozen=True)
class DecodeConfig:
    """Beam decoding. The semantics of each knob are documented on the JAX
    package's DecodeConfig; the port implements beam_finish, beam_prune,
    block_ngram, max_len_factor/offset, the fp32 compute dtype, greedy
    decode (beam_size 1) and the streaming-refill decoder (streaming,
    refill_threshold). The two-phase decoder and beam_unroll > 1 are later
    slices (translate_corpus raises NotImplementedError when they resolve
    on)."""

    beam_size: int = 5
    max_len: int = 64
    length_norm_alpha: float = 1.0
    decode_batch_size: int = 128
    beam_unroll: int = 1
    two_phase: str = "auto"
    split_len: int = 0
    beam_finish: str = "all_frozen"
    beam_prune: str = "on"
    block_ngram: int = 0
    max_len_factor: float = 0.0
    max_len_offset: int = 0
    compute_dtype: str = "float32"
    streaming: str = "auto"
    refill_threshold: int = 0


@dataclass(frozen=True)
class MeshConfig:
    data_axis: int = -1
    model_axis: int = 1


@dataclass(frozen=True)
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    name: str = "custom"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        def build(cls, sub):
            fields = {f.name for f in dataclasses.fields(cls)}
            kwargs = {}
            for k, v in sub.items():
                if k not in fields:
                    raise KeyError(f"unknown config key {cls.__name__}.{k}")
                kwargs[k] = tuple(v) if isinstance(v, list) else v
            return cls(**kwargs)

        return Config(
            model=build(ModelConfig, d.get("model", {})),
            data=build(DataConfig, d.get("data", {})),
            train=build(TrainConfig, d.get("train", {})),
            decode=build(DecodeConfig, d.get("decode", {})),
            mesh=build(MeshConfig, d.get("mesh", {})),
            name=d.get("name", "custom"),
        )

    @staticmethod
    def from_json(s: str) -> "Config":
        return Config.from_dict(json.loads(s))

    def replace(self, **section_updates) -> "Config":
        """cfg.replace(model={'emb_dim': 512}, name='x') — section-wise update."""
        new = {}
        for key, val in section_updates.items():
            cur = getattr(self, key)
            new[key] = (dataclasses.replace(cur, **val) if isinstance(val, dict)
                        else val)
        return dataclasses.replace(self, **new)


def _base(name: str, **sections) -> Config:
    return Config(name=name).replace(**sections)


PRESETS: Dict[str, Config] = {
    "m30k_ende_text": _base(
        "m30k_ende_text",
        model=dict(multimodal=False, emb_dim=256, hidden_dim=256,
                   dec_hidden_dim=256, attn_dim=256, enc_layers=1),
        data=dict(dataset="multi30k", src_lang="en", tgt_lang="de"),
        decode=dict(beam_size=1),
    ),
    "m30k_ende_vag": _base(
        "m30k_ende_vag",
        model=dict(multimodal=True, emb_dim=256, hidden_dim=512,
                   dec_hidden_dim=512, attn_dim=512, enc_layers=1,
                   shared_dim=512),
        data=dict(dataset="multi30k", src_lang="en", tgt_lang="de"),
        decode=dict(beam_size=5),
    ),
    "m30k_enfr_vag": _base(
        "m30k_enfr_vag",
        model=dict(multimodal=True, emb_dim=256, hidden_dim=512,
                   dec_hidden_dim=512, attn_dim=512, enc_layers=1,
                   shared_dim=512),
        data=dict(dataset="multi30k", src_lang="en", tgt_lang="fr"),
        decode=dict(beam_size=5),
    ),
    "ikea_vag": _base(
        "ikea_vag",
        model=dict(multimodal=True, emb_dim=256, hidden_dim=512,
                   dec_hidden_dim=512, attn_dim=512, enc_layers=1,
                   shared_dim=512, src_vocab_size=16000, tgt_vocab_size=16000),
        data=dict(dataset="ikea", max_src_len=128, max_tgt_len=128,
                  bpe_merges=16000,
                  length_buckets=(16, 32, 48, 64, 96, 128)),
        decode=dict(beam_size=5, max_len=128),
    ),
    "m30k_scaled": _base(
        "m30k_scaled",
        model=dict(multimodal=True, emb_dim=512, hidden_dim=512,
                   dec_hidden_dim=512, attn_dim=512, enc_layers=2,
                   shared_dim=512),
        data=dict(dataset="multi30k", src_lang="en", tgt_lang="de"),
        decode=dict(beam_size=5),
        mesh=dict(model_axis=1),
    ),
    "toy": _base(
        "toy",
        model=dict(multimodal=True, src_vocab_size=64, tgt_vocab_size=64,
                   emb_dim=32, hidden_dim=32, dec_hidden_dim=32, attn_dim=32,
                   shared_dim=32, img_feat_dim=64, dropout=0.0),
        data=dict(dataset="toy", batch_size=16, max_src_len=16, max_tgt_len=16,
                  length_buckets=(8, 16)),
        decode=dict(beam_size=3, max_len=16, decode_batch_size=16),
        train=dict(learning_rate=3e-3, eval_every_steps=200,
                   steps_per_dispatch=1),
    ),
}


def preset(name: str) -> Config:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]
