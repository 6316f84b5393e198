"""Configuration of the port: its own copy of the JAX package's model and
evaluation dataclasses (`cvc_tpu/config.py`), with the same field names and
defaults, so a `config.json` that `cvc_tpu` wrote loads here unchanged.

`ModelConfig`, `EvalConfig` and `TrainConfig` are typed. The data section
of a `config.json` is kept as a plain dict. The reference-style command
line waits for the training loop's slice.
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
class TrainConfig:
    """The optimizer, schedule and cycle settings of training. Fields the
    port does not read yet (the loop, scheduled sampling, SCST,
    checkpoints, multi-device) are kept so every `cvc_tpu` config
    loads."""

    learning_rate: float = 5e-4       # reference: --learning_rate
    optimizer: str = "adam"
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.1            # clip by global norm
    learning_rate_decay_start: int = 1      # epoch (reference flag name)
    learning_rate_decay_every: int = 3      # epochs
    learning_rate_decay_rate: float = 0.8
    max_epochs: int = 30
    enable_cycle: bool = True         # decode -> localize -> reconstruct
    cycle_after: int = 0              # the cycle only from this epoch
    cycle_gt_until: int = 0           # epochs in [cycle_after, this) query
    #                                   the localizer with the GT words
    cycle_weight_anneal_to: float = -1.0   # >= 0: reconstruction weight
    #                                   after cycle_weight_anneal_after
    cycle_weight_anneal_after: int = 0
    scheduled_sampling_start: int = -1        # epoch; -1 = off
    scheduled_sampling_increase_every: int = 5
    scheduled_sampling_increase_prob: float = 0.05
    scheduled_sampling_max_prob: float = 0.25
    self_critical_after: int = -1             # epoch; -1 = off
    scst_xe_weight: float = 0.0
    checkpoint_path: str = "save"
    start_from: Optional[str] = None
    import_torch: Optional[str] = None
    auto_resume: bool = True
    save_checkpoint_every: int = 1    # epochs
    val_every_epoch: int = 1
    language_eval: bool = True
    grounding_eval: bool = True
    cycle_probes: bool = False
    beam_size: int = 1                # decode config used during validation
    losses_log_every: int = 25        # steps
    seed: int = 123
    num_devices: int = 0              # 0 = all visible devices
    model_axis: int = 1
    donate_state: bool = True


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    data: dict = field(default_factory=dict)    # untyped until ported
    train: TrainConfig = field(default_factory=TrainConfig)
    id: str = "cvc"

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)
        return Config(
            model=ModelConfig(**raw.get("model", {})),
            eval=EvalConfig(**raw.get("eval", {})),
            data=dict(raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            id=raw.get("id", "cvc"),
        )
