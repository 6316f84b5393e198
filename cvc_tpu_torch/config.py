"""Configuration of the port: its own copy of the JAX package's dataclasses
and reference-style command line (`cvc_tpu/config.py`), with the same field
names, flags and defaults, so a `config.json` that `cvc_tpu` wrote loads
here unchanged and `to_json` writes the same dict back.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


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
class DataConfig:
    """The input pipeline: the dataset and its files, batching, and the
    synthetic world's knobs (data/synthetic.py)."""

    dataset: str = "flickr30k"        # "flickr30k" | "anet" | "synthetic"
    feature_file: str = ""            # HDF5 of per-image region features
    annotation_file: str = ""         # captions + entity boxes JSON
    vocab_file: str = ""              # word <-> id JSON
    batch_size: int = 64
    device_resident: bool = False     # the train set kept on the device
    shuffle: bool = True
    seed: int = 0
    prefetch: int = 2
    num_workers: int = 2              # host threads assembling batches
    synthetic_num_images: int = 256
    synthetic_vocab_size: int = 1000
    synthetic_word_order: str = "sorted"   # "shuffled": class words only
    #                                   predictable through word-aligned
    #                                   attention
    synthetic_unique_colors: bool = False
    synthetic_num_classes: int = 24
    synthetic_num_val_images: int = 0  # 0 = synthetic_num_images
    synthetic_easy_frac: float = 0.0   # share of images with only
    #                                   easy_regions proposals
    synthetic_easy_regions: int = 12
    synthetic_class_skew: float = 0.0  # Zipf exponent of object classes
    synthetic_refs_per_image: int = 1  # reference captions per image
    synthetic_ref_subset: bool = False  # each reference mentions a random
    #                                    subset of the objects
    synthetic_attr_noise: float = 0.0  # prob. a color word is resampled
    synthetic_distractor_corr: float = 0.0  # blend of a true object's
    #                                   class center into distractors


@dataclass
class TrainConfig:
    """The optimizer, schedule and cycle settings of training. Fields the
    port does not read yet (the loop, checkpoints, multi-device) are kept
    so every `cvc_tpu` config loads."""

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
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    id: str = "cvc"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(s: str) -> "Config":
        raw = json.loads(s)
        return Config(
            model=ModelConfig(**raw.get("model", {})),
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            eval=EvalConfig(**raw.get("eval", {})),
            id=raw.get("id", "cvc"),
        )


# ---------------------------------------------------------------------------
# Reference-style CLI (reference: opts.parse_opt()).
# ---------------------------------------------------------------------------

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="cyclical grounded visual captioning (PyTorch/CUDA)",
        fromfile_prefix_chars="@",
    )
    # Data (reference flag names preserved where they existed).
    p.add_argument("--dataset", type=str, default="flickr30k",
                   choices=["flickr30k", "anet", "synthetic"])
    p.add_argument("--feature_file", type=str, default="")
    p.add_argument("--annotation_file", type=str, default="")
    p.add_argument("--vocab_file", type=str, default="")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--device_resident", type=int, default=0,
                   help="keep the train set on the device and gather "
                        "batches there (one upload in all)")
    p.add_argument("--num_workers", type=int, default=1,
                   help="host threads assembling batches")
    p.add_argument("--prefetch", type=int, default=2)
    p.add_argument("--synthetic_num_images", type=int, default=256,
                   help="--dataset synthetic: images per split")
    p.add_argument("--synthetic_vocab_size", type=int, default=1000)
    p.add_argument("--synthetic_word_order", type=str, default="sorted",
                   choices=["sorted", "shuffled"],
                   help="'shuffled' = the grounding-ablation world: class "
                        "words require word-aligned attention")
    p.add_argument("--synthetic_unique_colors", type=int, default=0)
    p.add_argument("--synthetic_num_classes", type=int, default=24)
    p.add_argument("--synthetic_num_val_images", type=int, default=0,
                   help="0 = same as --synthetic_num_images")
    p.add_argument("--synthetic_easy_frac", type=float, default=0.0,
                   help="fraction of images with only "
                        "--synthetic_easy_regions proposals (partial-"
                        "alignment world; see data/synthetic.py)")
    p.add_argument("--synthetic_easy_regions", type=int, default=12)
    p.add_argument("--synthetic_class_skew", type=float, default=0.0,
                   help="Zipf exponent for object-class sampling (0 = "
                        "uniform; ~1 = real-data-like head/tail)")
    p.add_argument("--synthetic_refs_per_image", type=int, default=1,
                   help="reference captions per synthetic image (COCO-"
                        "style multi-ref; dense SCST reward)")
    p.add_argument("--synthetic_ref_subset", type=int, default=0,
                   help="1: each reference mentions a random subset of "
                        "the objects (coverage slack; the regime where "
                        "SCST can beat XE)")
    p.add_argument("--synthetic_attr_noise", type=float, default=0.0,
                   help="prob. an emitted color word is resampled at "
                        "random (noisy ANet-like regime: attention "
                        "helpful but insufficient)")
    p.add_argument("--synthetic_distractor_corr", type=float, default=0.0,
                   help="blend of a random true-object class center "
                        "into every distractor feature (0..1)")
    p.add_argument("--feat_dim", type=int, default=2048,
                   help="region feature dim (reference: 2048-d fc6)")
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--seq_length", type=int, default=20)
    p.add_argument("--global_feat_dim", type=int, default=-1,
                   help="segment-level global feature dim (-1 = dataset "
                        "default: 3072 for anet, else 0 = mean-pool)")
    p.add_argument("--num_props", type=int, default=100,
                   help="region proposals per image/frame (padded to a static shape)")
    p.add_argument("--num_frames", type=int, default=1)
    # Model.
    p.add_argument("--rnn_size", type=int, default=1024)
    p.add_argument("--input_encoding_size", type=int, default=512)
    p.add_argument("--att_hid_size", type=int, default=512)
    p.add_argument("--drop_prob_lm", type=float, default=0.5)
    p.add_argument("--obj_interact", type=int, default=0)
    p.add_argument("--enable_cycle", type=int, default=1,
                   help="cyclical decode->localize->reconstruct training (the method)")
    p.add_argument("--cycle_weight", type=float, default=1.0)
    p.add_argument("--cycle_localize_gt", type=int, default=0)
    p.add_argument("--cycle_after", type=int, default=0)
    p.add_argument("--cycle_gt_until", type=int, default=0,
                   help="GT-word localizer queries until this epoch "
                        "(cycle cold-start bootstrap), then argmax")
    p.add_argument("--cycle_weight_anneal_to", type=float, default=-1.0,
                   help=">=0: reconstruction weight switches from "
                        "--cycle_weight to this value at epoch "
                        "--cycle_weight_anneal_after (<0 = off)")
    p.add_argument("--cycle_weight_anneal_after", type=int, default=0)
    p.add_argument("--use_pallas", type=int, default=-1,
                   help="attention/LSTM kernels: -1 auto (on CUDA), 0 "
                        "off, 1 on")
    p.add_argument("--pallas_select", type=int, default=-1,
                   help="beam-select top-k + logsumexp kernel: -1 auto "
                        "(on CUDA), 0 off, 1 on")
    p.add_argument("--scan_unroll", type=int, default=1,
                   help="decode-scan unroll factor (kept for config "
                        "compatibility; the port's loops do not unroll)")
    p.add_argument("--train_scan_unroll", type=int, default=0,
                   help="teacher-forced-scan unroll; 0 = inherit "
                        "scan_unroll (kept for config compatibility)")
    p.add_argument("--stacked_grad", type=int, default=1,
                   help="hand-written decode-scan backward: recomputed "
                        "attention tanh + stacked [L*B] weight-gradient "
                        "products (0 = the per-step autograd scan)")
    p.add_argument("--attn_supervision_weight", type=float, default=0.0,
                   help=">0 trains grounding with box supervision (the "
                        "GVD-supervised baseline; the cyclical method "
                        "itself never uses this)")
    p.add_argument("--dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    # Optimization.
    p.add_argument("--learning_rate", type=float, default=5e-4)
    p.add_argument("--learning_rate_decay_start", type=int, default=1)
    p.add_argument("--learning_rate_decay_every", type=int, default=3)
    p.add_argument("--learning_rate_decay_rate", type=float, default=0.8)
    p.add_argument("--grad_clip", type=float, default=0.1)
    p.add_argument("--max_epochs", type=int, default=30)
    p.add_argument("--scheduled_sampling_start", type=int, default=-1)
    p.add_argument("--scheduled_sampling_increase_every", type=int, default=5)
    p.add_argument("--scheduled_sampling_increase_prob", type=float,
                   default=0.05)
    p.add_argument("--scheduled_sampling_max_prob", type=float, default=0.25)
    p.add_argument("--self_critical_after", type=int, default=-1)
    p.add_argument("--scst_xe_weight", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=123)
    # Checkpointing / eval cadence.
    p.add_argument("--checkpoint_path", type=str, default="save")
    p.add_argument("--start_from", type=str, default=None)
    p.add_argument("--import_torch", type=str, default=None,
                   help="reference torch .pth (or converted .npz) to "
                        "initialize params from")
    p.add_argument("--save_checkpoint_every", type=int, default=1)
    p.add_argument("--val_every_epoch", type=int, default=1)
    p.add_argument("--language_eval", type=int, default=1)
    p.add_argument("--grounding_eval", type=int, default=1)
    p.add_argument("--losses_log_every", type=int, default=25)
    # Inference.
    p.add_argument("--beam_size", type=int, default=5)
    p.add_argument("--sample_method", type=str, default="beam",
                   choices=["beam", "greedy", "sample"])
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--length_penalty", type=float, default=0.0)
    p.add_argument("--grounding_source", type=str, default="decoder",
                   choices=["decoder", "localizer"])
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--out_dir", type=str, default="eval_out")
    p.add_argument("--gt_sentence_mode", type=int, default=0)
    p.add_argument("--cycle_probes", type=int, default=0,
                   help="log cycle-mechanism diagnostics at every "
                        "validation (tf_attn_acc, localizer-beta acc, "
                        "v-hat dependence)")
    # Parallelism (the reference's --mGPUs): one process a rank, NCCL or
    # gloo (parallel/launch.py, parallel/mesh.py).
    p.add_argument("--mGPUs", "--num_devices", dest="num_devices", type=int,
                   default=0,
                   help="devices for data-parallel training; 0 = all "
                        "visible")
    p.add_argument("--model_axis", type=int, default=1,
                   help="width of the vocabulary head's split (1 = off)")
    p.add_argument("--id", type=str, default="cvc")
    p.add_argument("--config_json", type=str, default=None,
                   help="load a full Config JSON (CLI flags override)")
    return p


def _defaults_from_config(cfg: Config) -> dict:
    """Flatten a Config into the CLI's arg-name namespace.

    Used to re-seed argparse *defaults* when --config_json is given, so
    the JSON supplies every mirrored value and only flags the user typed
    explicitly override it (previously argparse defaults silently
    clobbered the file).
    """
    m, d, t, e = cfg.model, cfg.data, cfg.train, cfg.eval
    return dict(
        dataset=d.dataset, feature_file=d.feature_file,
        annotation_file=d.annotation_file, vocab_file=d.vocab_file,
        batch_size=d.batch_size, device_resident=int(d.device_resident),
        num_workers=d.num_workers, prefetch=d.prefetch,
        synthetic_num_images=d.synthetic_num_images,
        synthetic_vocab_size=d.synthetic_vocab_size,
        synthetic_word_order=d.synthetic_word_order,
        synthetic_unique_colors=int(d.synthetic_unique_colors),
        synthetic_num_classes=d.synthetic_num_classes,
        synthetic_num_val_images=d.synthetic_num_val_images,
        synthetic_easy_frac=d.synthetic_easy_frac,
        synthetic_easy_regions=d.synthetic_easy_regions,
        synthetic_class_skew=d.synthetic_class_skew,
        synthetic_refs_per_image=d.synthetic_refs_per_image,
        synthetic_ref_subset=int(d.synthetic_ref_subset),
        synthetic_attr_noise=d.synthetic_attr_noise,
        synthetic_distractor_corr=d.synthetic_distractor_corr,
        feat_dim=m.feat_dim, weight_decay=t.weight_decay,
        seq_length=m.seq_length,
        num_props=m.num_regions, num_frames=m.num_frames,
        rnn_size=m.rnn_size, input_encoding_size=m.input_encoding_size,
        att_hid_size=m.att_hid_size, drop_prob_lm=m.drop_prob_lm,
        obj_interact=int(m.obj_interact), enable_cycle=int(t.enable_cycle),
        cycle_weight=m.cycle_weight, cycle_after=t.cycle_after,
        cycle_gt_until=t.cycle_gt_until,
        cycle_weight_anneal_to=t.cycle_weight_anneal_to,
        cycle_weight_anneal_after=t.cycle_weight_anneal_after,
        cycle_localize_gt=int(m.cycle_localize_gt),
        use_pallas=-1 if m.use_pallas is None else int(m.use_pallas),
        pallas_select=-1 if m.pallas_select is None
        else int(m.pallas_select),
        scan_unroll=m.scan_unroll,
        train_scan_unroll=m.train_scan_unroll,
        stacked_grad=int(m.stacked_grad),
        attn_supervision_weight=m.attn_supervision_weight,
        dtype=m.dtype,
        learning_rate=t.learning_rate,
        learning_rate_decay_start=t.learning_rate_decay_start,
        learning_rate_decay_every=t.learning_rate_decay_every,
        learning_rate_decay_rate=t.learning_rate_decay_rate,
        grad_clip=t.grad_clip, max_epochs=t.max_epochs,
        scheduled_sampling_start=t.scheduled_sampling_start,
        scheduled_sampling_increase_every=t.scheduled_sampling_increase_every,
        scheduled_sampling_increase_prob=t.scheduled_sampling_increase_prob,
        scheduled_sampling_max_prob=t.scheduled_sampling_max_prob,
        self_critical_after=t.self_critical_after,
        scst_xe_weight=t.scst_xe_weight, seed=t.seed,
        checkpoint_path=t.checkpoint_path, start_from=t.start_from,
        save_checkpoint_every=t.save_checkpoint_every,
        val_every_epoch=t.val_every_epoch,
        language_eval=int(t.language_eval),
        grounding_eval=int(t.grounding_eval),
        cycle_probes=int(t.cycle_probes),
        losses_log_every=t.losses_log_every,
        beam_size=e.beam_size, sample_method=e.sample_method,
        temperature=e.temperature, length_penalty=e.length_penalty,
        grounding_source=e.grounding_source, split=e.split,
        out_dir=e.out_dir, gt_sentence_mode=int(e.gt_sentence_mode),
        num_devices=t.num_devices, model_axis=t.model_axis, id=cfg.id,
    )


def config_from_args(argv=None) -> Config:
    # Two-phase parse: find --config_json first, then seed the full
    # parser's defaults from it so explicit CLI flags (and only those)
    # override the file.
    pre = argparse.ArgumentParser(add_help=False)
    pre.add_argument("--config_json", type=str, default=None)
    pre_args, _ = pre.parse_known_args(argv)
    parser = build_parser()
    if pre_args.config_json:
        with open(pre_args.config_json) as f:
            cfg = Config.from_json(f.read())
        parser.set_defaults(**_defaults_from_config(cfg))
    else:
        cfg = Config()
    args = parser.parse_args(argv)

    m, d, t, e = cfg.model, cfg.data, cfg.train, cfg.eval
    d.dataset = args.dataset
    d.feature_file = args.feature_file
    d.annotation_file = args.annotation_file
    d.vocab_file = args.vocab_file
    d.batch_size = args.batch_size
    d.device_resident = bool(args.device_resident)
    d.num_workers = args.num_workers
    d.prefetch = args.prefetch
    d.synthetic_num_images = args.synthetic_num_images
    d.synthetic_vocab_size = args.synthetic_vocab_size
    d.synthetic_word_order = args.synthetic_word_order
    d.synthetic_unique_colors = bool(args.synthetic_unique_colors)
    d.synthetic_num_classes = args.synthetic_num_classes
    d.synthetic_num_val_images = args.synthetic_num_val_images
    d.synthetic_easy_frac = args.synthetic_easy_frac
    d.synthetic_easy_regions = args.synthetic_easy_regions
    d.synthetic_class_skew = args.synthetic_class_skew
    d.synthetic_refs_per_image = args.synthetic_refs_per_image
    d.synthetic_ref_subset = bool(args.synthetic_ref_subset)
    d.synthetic_attr_noise = args.synthetic_attr_noise
    d.synthetic_distractor_corr = args.synthetic_distractor_corr
    d.seed = args.seed

    m.seq_length = args.seq_length
    m.feat_dim = args.feat_dim
    t.weight_decay = args.weight_decay
    m.num_regions = _round_up(args.num_props, 8)
    m.num_frames = args.num_frames
    m.rnn_size = args.rnn_size
    m.input_encoding_size = args.input_encoding_size
    m.att_hid_size = args.att_hid_size
    m.drop_prob_lm = args.drop_prob_lm
    m.obj_interact = bool(args.obj_interact)
    m.cycle_weight = args.cycle_weight
    m.cycle_localize_gt = bool(args.cycle_localize_gt)
    m.attn_supervision_weight = args.attn_supervision_weight
    m.use_pallas = None if args.use_pallas < 0 else bool(args.use_pallas)
    m.pallas_select = (None if args.pallas_select < 0
                       else bool(args.pallas_select))
    m.scan_unroll = args.scan_unroll
    m.train_scan_unroll = args.train_scan_unroll
    m.stacked_grad = bool(args.stacked_grad)
    m.dtype = args.dtype
    if args.global_feat_dim >= 0:
        m.global_feat_dim = args.global_feat_dim
    if args.dataset == "anet" and args.num_frames == 1:
        m.num_frames = 10
        if args.global_feat_dim < 0:
            m.global_feat_dim = 3072

    t.learning_rate = args.learning_rate
    t.learning_rate_decay_start = args.learning_rate_decay_start
    t.learning_rate_decay_every = args.learning_rate_decay_every
    t.learning_rate_decay_rate = args.learning_rate_decay_rate
    t.grad_clip = args.grad_clip
    t.max_epochs = args.max_epochs
    t.scheduled_sampling_start = args.scheduled_sampling_start
    t.scheduled_sampling_increase_every = args.scheduled_sampling_increase_every
    t.scheduled_sampling_increase_prob = args.scheduled_sampling_increase_prob
    t.scheduled_sampling_max_prob = args.scheduled_sampling_max_prob
    t.self_critical_after = args.self_critical_after
    t.scst_xe_weight = args.scst_xe_weight
    t.enable_cycle = bool(args.enable_cycle)
    t.cycle_after = args.cycle_after
    t.cycle_gt_until = args.cycle_gt_until
    t.cycle_weight_anneal_to = args.cycle_weight_anneal_to
    t.cycle_weight_anneal_after = args.cycle_weight_anneal_after
    t.checkpoint_path = args.checkpoint_path
    t.start_from = args.start_from
    t.import_torch = args.import_torch
    t.save_checkpoint_every = args.save_checkpoint_every
    t.val_every_epoch = args.val_every_epoch
    t.language_eval = bool(args.language_eval)
    t.grounding_eval = bool(args.grounding_eval)
    t.cycle_probes = bool(args.cycle_probes)
    e.cycle_probes = bool(args.cycle_probes)
    t.losses_log_every = args.losses_log_every
    t.seed = args.seed
    t.num_devices = args.num_devices
    t.model_axis = args.model_axis

    e.beam_size = args.beam_size
    e.sample_method = args.sample_method
    e.temperature = args.temperature
    e.length_penalty = args.length_penalty
    e.grounding_source = args.grounding_source
    e.split = args.split
    e.out_dir = args.out_dir
    e.max_length = args.seq_length
    e.language_eval = bool(args.language_eval)
    e.grounding_eval = bool(args.grounding_eval)
    e.gt_sentence_mode = bool(args.gt_sentence_mode)

    cfg.id = args.id
    return cfg
