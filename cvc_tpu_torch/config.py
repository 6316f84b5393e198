"""Configuration of the port: its own copy of the JAX package's model and
evaluation dataclasses (`cvc_tpu/config.py`), with the same field names and
defaults, so a `config.json` that `cvc_tpu` wrote loads here unchanged.

Only what serving reads is typed: `ModelConfig` and `EvalConfig`. The data
and train sections of a `config.json` are kept as plain dicts. The
reference-style command line belongs to the training slice.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class ModelConfig:
    """Architecture of the cyclical grounded-captioning model (Up-Down
    attention-LSTM decoder). Fields the port does not read yet are kept so
    every `cvc_tpu` config loads; the training slice reads them."""

    vocab_size: int = 8704            # padded to a multiple of 128
    input_encoding_size: int = 512    # word embedding dim E
    rnn_size: int = 1024              # LSTM hidden dim H
    att_hid_size: int = 512           # additive-attention hidden dim A
    feat_dim: int = 2048              # region feature dim
    global_feat_dim: int = 0          # segment feature dim; 0 = mean-pool regions
    num_regions: int = 128            # padded region slots per frame
    num_frames: int = 1               # >1 for video segments
    seq_length: int = 20              # caption length budget
    num_classes: int = 512            # detector class vocabulary
    class_emb_dim: int = 128
    drop_prob_lm: float = 0.5
    obj_interact: bool = False        # region self-attention encoder
    obj_interact_layers: int = 1
    obj_interact_heads: int = 4
    cycle_weight: float = 1.0
    cycle_localize_gt: bool = False
    attention_entropy_weight: float = 0.0
    attn_supervision_weight: float = 0.0
    use_box_geometry: bool = True     # box geometry into the region encoder
    use_global_feat: bool = True      # False: zero v_global (ablation knob)
    use_pallas: Optional[bool] = None  # attention/LSTM kernels; None = auto
    #                                   (ops/dispatch.py: kernels on CUDA)
    dtype: str = "float32"            # "float32" | "bfloat16"
    beam_select_bf16: bool = False    # bf16 models: beam-select on bf16
    #                                   logits (near-ties may resolve
    #                                   differently than float32 select)
    pallas_select: Optional[bool] = None  # top-k + lse kernel; None = auto
    scan_unroll: int = 1
    train_scan_unroll: int = 0
    remat: bool = False
    stacked_grad: bool = True
    fuse_cycle_scans: bool = True

    @property
    def total_regions(self) -> int:
        """Attention slots = frames * regions."""
        return self.num_frames * self.num_regions

    @property
    def max_tokens(self) -> int:
        """Token buffer length: BOS + seq_length + EOS."""
        return self.seq_length + 2


@dataclass
class EvalConfig:
    beam_size: int = 5
    max_length: int = 20
    length_penalty: float = 0.0       # alpha; 0 = pure logprob
    temperature: float = 1.0
    sample_method: str = "beam"       # "beam" | "greedy" | "sample"
    split: str = "test"
    out_dir: str = "eval_out"
    language_eval: bool = True
    grounding_eval: bool = True
    gt_sentence_mode: bool = False
    cycle_probes: bool = False
    grounding_source: str = "decoder"


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    data: dict = field(default_factory=dict)    # untyped until ported
    train: dict = field(default_factory=dict)   # untyped until ported
    id: str = "cvc"

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)
        return Config(
            model=ModelConfig(**raw.get("model", {})),
            eval=EvalConfig(**raw.get("eval", {})),
            data=dict(raw.get("data", {})),
            train=dict(raw.get("train", {})),
            id=raw.get("id", "cvc"),
        )
