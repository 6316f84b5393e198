"""Shapes, inputs, FLOP counts and timers of the port's measurement tools:
the port's own copy of `bench.py:46-214`, with the H100's peaks in place of
the TPU's.

- `flagship_config` and `video_config`: the flagship serving model
  (vocab 8704, E 512, H 1024, A 512, 2048-d features, 128 region slots, 20
  words) and its video width (10 frames of 128 slots, a 3072-d global
  feature), the configurations `bench.py` and `tools/throughput_table.py`
  measure.
- `random_arrays`: a batch made with numpy from a seed, in the order
  `bench.random_arrays` draws it, so that its arrays equal the JAX
  package's bit for bit.
- The analytic FLOP counts (matmul terms only): `per_row_step_flops`,
  `encode_flops`, `caption_flops`, `train_image_flops`.
- The timers `bench_decode` and `bench_train` (the best of `WINDOWS`
  windows of `iters` calls, every window printed) and
  `bench_serving_sustained` (depth-4 pipelined submission of fresh host
  inputs over a wall-clock window). Each waits for the card with
  `torch.cuda.synchronize` before it reads the clock.
- The card: `card(device)` names the device and carries `nvidia-smi`'s
  name and power limit beside every number a tool writes.

MFU is the analytic FLOPs over the card's dense peak for the model's
compute type (`PEAK_OPS`); bytes over `HBM_BYTES_PER_S`. These are the
published rates of one NVIDIA H100 SXM at its 700 W limit; a card set
below it runs slower.
"""

from __future__ import annotations

import json
import os
import subprocess
import time

import numpy as np
import torch

from cvc_tpu_torch.config import ModelConfig, TrainConfig

BATCH = 64
BEAM = 5
SEQ = 20
WINDOWS = 3                                  # timed windows; the best is kept
DECODE_ITERS = 10                            # decodes a window (bench.py's)
TRAIN_ITERS = 20                             # train steps a window (bench.py's)

HBM_BYTES_PER_S = 3.35e12                    # H100 SXM
PEAK_OPS = {"bfloat16": 989e12,              # dense bf16 tensor cores
            "float32": 67e12}                # float32 outside tensor cores

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
OUT_DIR = os.path.join(REPO_ROOT, "experiments", "h100")


def flagship_config(**kw) -> ModelConfig:
    """`bench.py:51-60`'s flagship model. The port reads neither unroll
    field (its scans are Python loops); they are kept so that the config
    writes the same JSON."""
    base = dict(vocab_size=8704, input_encoding_size=512, rnn_size=1024,
                att_hid_size=512, feat_dim=2048, num_regions=128,
                num_frames=1, seq_length=SEQ, num_classes=512,
                class_emb_dim=128, drop_prob_lm=0.5,
                scan_unroll=7, train_scan_unroll=SEQ + 1)
    base.update(kw)
    return ModelConfig(**base)


# the widths of the tools' --tiny switch (`tools/attribution_bench.py
# --tiny`): the harness at a size a CPU runs in seconds
TINY = dict(vocab_size=512, rnn_size=128, input_encoding_size=64,
            att_hid_size=64, feat_dim=128, num_regions=16, num_classes=32,
            class_emb_dim=16)


def video_config(**kw) -> ModelConfig:
    """The ActivityNet-Entities width of `bench.py --video` and
    `tools/throughput_table.py --video`: 10 frames x 128 slots (100
    proposals each) and a 3072-d segment feature."""
    return flagship_config(**dict(dict(num_frames=10, global_feat_dim=3072),
                                  **kw))


def random_arrays(cfg: ModelConfig, batch: int, seed: int = 0,
                  device="cuda") -> dict:
    """`bench.random_arrays`: captions of SEQ random words, 100 live
    proposals a frame, features, boxes and classes from numpy's generator
    in the same order, as tensors on `device`."""
    rng = np.random.default_rng(seed)
    S = cfg.total_regions
    T = cfg.max_tokens
    tokens = np.zeros((batch, T), np.int32)
    tokens[:, 0] = 1
    tokens[:, 1:SEQ + 1] = rng.integers(4, cfg.vocab_size, (batch, SEQ))
    tokens[:, SEQ + 1] = 2
    live = (np.arange(S)[None, :] % cfg.num_regions) < 100
    out = dict(
        feats=rng.normal(size=(batch, S, cfg.feat_dim)).astype(np.float32),
        box_geom=rng.uniform(size=(batch, S, 5)).astype(np.float32),
        region_cls=rng.integers(0, cfg.num_classes,
                                size=(batch, S)).astype(np.int32),
        region_mask=(live.astype(np.float32)
                     * np.ones((batch, 1), np.float32)),
        tokens=tokens,
        token_mask=np.ones((batch, T), np.float32),
    )
    if cfg.global_feat_dim:
        out["global_feat"] = rng.normal(
            size=(batch, cfg.global_feat_dim)).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


# ---------------------------------------------------------------------------
# Analytic FLOPs (matmul terms only; elementwise excluded -> conservative)
# ---------------------------------------------------------------------------

def per_row_step_flops(cfg: ModelConfig) -> float:
    """One autoregressive decoder step for one (batch*beam) row."""
    H, E, A, V, S = (cfg.rnn_size, cfg.input_encoding_size,
                     cfg.att_hid_size, cfg.vocab_size, cfg.total_regions)
    att_lstm = 8 * H * (E + 2 * H)        # emb/h_lang/h_att gate matmuls
    attention = 2 * H * A + 4 * S * A + 2 * S * H
    lang_lstm = 24 * H * H                # ctx/h_att/h_lang gate matmuls
    logits = 2 * H * V
    return float(att_lstm + attention + lang_lstm + logits)


def encode_flops(cfg: ModelConfig) -> float:
    S = cfg.total_regions
    return float(2 * S * cfg.feat_dim * cfg.rnn_size            # region proj
                 + 2 * S * cfg.rnn_size * cfg.att_hid_size)     # keys


def caption_flops(cfg: ModelConfig, beam: int) -> float:
    L = cfg.seq_length + 1
    return encode_flops(cfg) + beam * L * per_row_step_flops(cfg)


def train_image_flops(cfg: ModelConfig) -> float:
    """Cyclical train step per image: forward (decode scan + localizer +
    reconstruct scan) x3 for fwd+bwd."""
    L = cfg.max_tokens - 1
    S, A, E = cfg.total_regions, cfg.att_hid_size, cfg.input_encoding_size
    localizer = L * (2 * E * A + 2 * S * A + 2 * S * cfg.rnn_size)
    fwd = encode_flops(cfg) + 2 * L * per_row_step_flops(cfg) + localizer
    return 3.0 * fwd


# ---------------------------------------------------------------------------
# The card
# ---------------------------------------------------------------------------

def nvidia_smi_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line (the card's name and power limit)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def card(device) -> dict:
    """What a tool's JSON says of the device its numbers come from:
    {"platform": "gpu" or "cpu", "device_kind": the card's name or "cpu",
    "nvidia_smi": the card's name and power limit, None on the CPU}."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "device_kind": "cpu", "nvidia_smi": None}
    return {"platform": "gpu",
            "device_kind": torch.cuda.get_device_name(device),
            "nvidia_smi": nvidia_smi_line()}


def sync(device) -> None:
    """Wait until the work queued on `device` is done (nothing on the
    CPU, whose PyTorch calls return when they are done)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_windows(run, device, iters: int, windows: int = WINDOWS,
                 label: str = "") -> list[float]:
    """Seconds a call of `run()` in each of `windows` windows of `iters`
    calls queued back to back, the card waited for at the end of each
    window (one warm call first, not timed). Prints every window."""
    run()
    sync(device)
    out = []
    for w in range(windows):
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        sync(device)
        out.append((time.perf_counter() - t0) / iters)
        if label:
            print(f"{label}: window {w + 1}/{windows}: "
                  f"{out[-1] * 1e3:.3f} ms a call ({iters} calls)",
                  flush=True)
    return out


# ---------------------------------------------------------------------------
# Timers
# ---------------------------------------------------------------------------

def decoder_params(cfg, params):
    """The parameters cast once to the type the decoder runs in, as
    `serving.Captioner.build` casts them."""
    from cvc_tpu_torch.models import core
    return core.cast_params(params, core.decoder_dtype(cfg))


def bench_decode(cfg, params, batch: int = BATCH, device="cuda",
                 iters: int = DECODE_ITERS) -> dict:
    """Beam-5 captions/s on a resident batch: the best of WINDOWS windows
    of `iters` decodes queued back to back (a serving pipeline submits
    without waiting), each window ended by one wait for the card.
    Returns {"caps_per_sec": best, "window_caps_per_sec": every window}."""
    from cvc_tpu_torch.config import EvalConfig
    from cvc_tpu_torch.models.decoding import make_decoder
    decoder = make_decoder(cfg, EvalConfig(beam_size=BEAM, max_length=SEQ,
                                           sample_method="beam"), device)
    p = decoder_params(cfg, params)
    arrays = random_arrays(cfg, batch, device=device)
    times = time_windows(lambda: decoder(p, arrays), device, iters,
                         label=f"beam-{BEAM} decode B={batch} {cfg.dtype}")
    return {"caps_per_sec": batch / min(times),
            "window_caps_per_sec": [batch / t for t in times]}


def host_batches(cfg, batch: int, n: int, seed: int = 7) -> list[dict]:
    """`n` distinct host batches of serving inputs (numpy), 100 live
    proposals a frame."""
    rng = np.random.default_rng(seed)
    S = cfg.total_regions
    live = ((np.arange(S)[None, :] % cfg.num_regions) < 100)
    return [dict(
        feats=rng.normal(size=(batch, S, cfg.feat_dim)).astype(np.float32),
        box_geom=rng.uniform(size=(batch, S, 5)).astype(np.float32),
        region_cls=rng.integers(0, cfg.num_classes,
                                size=(batch, S)).astype(np.int32),
        region_mask=(live * np.ones((batch, 1))).astype(np.float32))
        for _ in range(n)]


def put(host: dict, device) -> dict:
    """Host arrays to `device`: pageable copies, queued without waiting
    for the work already on the stream."""
    return {k: torch.from_numpy(v).to(device, non_blocking=True)
            for k, v in host.items()}


def sustained(submit, wait, depth: int, secs: float, batch: int):
    """Batches submitted by `submit(i)` for `secs` of wall clock with
    `depth` in flight, `wait(result)` (a device-to-host read) on the
    oldest as the backpressure, all drained at the end. Returns (batches,
    seconds, the captions/s of each batch as it completed)."""
    from collections import deque
    inflight: deque = deque()
    per_batch = []
    n, t0 = 0, time.perf_counter()
    last = t0
    while time.perf_counter() - t0 < secs:
        inflight.append(submit(n))
        if len(inflight) >= depth:
            wait(inflight.popleft())
            now = time.perf_counter()
            per_batch.append(batch / (now - last))
            last = now
        n += 1
    while inflight:
        wait(inflight.popleft())
    return n, time.perf_counter() - t0, per_batch


def wait_tokens(res) -> None:
    """A decode's result waited for: its first token read to the host."""
    int(res["tokens"][0, 0])


def bench_serving_sustained(cfg, params, batch: int = 256,
                            secs: float = 30.0, device="cuda") -> dict:
    """Sustained captions/s with fresh host inputs, depth-4 pipelined
    submission (the copy of batch i+1 is queued while batch i runs; a
    device-to-host read of the oldest batch's first token is the
    backpressure), over `secs` of wall clock. Returns {"caps_per_sec",
    "batches", "secs"}."""
    from cvc_tpu_torch.config import EvalConfig
    from cvc_tpu_torch.models.decoding import make_decoder
    decoder = make_decoder(cfg, EvalConfig(beam_size=BEAM, max_length=SEQ,
                                           sample_method="beam"), device)
    p = decoder_params(cfg, params)
    hosts = host_batches(cfg, batch, 4)
    wait_tokens(decoder(p, put(hosts[0], device)))          # warm
    n, dt, _ = sustained(lambda i: decoder(p, put(hosts[i % 4], device)),
                         wait_tokens, 4, secs, batch)
    return {"caps_per_sec": batch * n / dt, "batches": n, "secs": dt}


def bench_train(cfg, params, batch: int | None = None, device="cuda",
                iters: int = TRAIN_ITERS) -> dict:
    """The cyclical train step (Adam at 5e-4, clip 0.1, dropout drawn from
    a seeded generator) on one repeated batch: the best of WINDOWS windows
    of `iters` steps. `params` (float32) become the state's and are
    updated in place: pass fresh ones."""
    from cvc_tpu_torch.training.optimizer import make_optimizer
    from cvc_tpu_torch.training.step import make_train_step
    from cvc_tpu_torch.training.train_state import TrainState
    batch = BATCH if batch is None else batch
    tc = TrainConfig(learning_rate=5e-4, grad_clip=0.1)
    state = TrainState.create(params, make_optimizer(tc, 1000))
    step = make_train_step(cfg, tc, 1000, device)
    arrays = random_arrays(cfg, batch, seed=1, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    times = time_windows(lambda: step(state, arrays, gen), device, iters,
                         label=f"train step B={batch} {cfg.dtype}")
    return dict(train_rates(cfg, batch, min(times)),
                window_step_ms=[t * 1e3 for t in times])


def train_rates(cfg, batch: int, seconds: float) -> dict:
    """A train step of `batch` images in `seconds` as `bench.bench_train`
    reports it: ms a step, images/s, tokens/s (seq_length + 1 a caption)
    and MFU against the card's peak for the model's type."""
    toks = float(batch * (cfg.seq_length + 1))
    return {"train_step_ms": seconds * 1e3,
            "train_images_per_sec": batch / seconds,
            "train_tokens_per_sec": toks / seconds,
            "train_mfu": batch * train_image_flops(cfg) / seconds
            / PEAK_OPS[cfg.dtype]}


# ---------------------------------------------------------------------------
# Output
# ---------------------------------------------------------------------------

def out_path(name: str) -> str:
    """The default output of a tool: experiments/h100/<name>."""
    return os.path.join(OUT_DIR, name)


def write_json(path: str, obj) -> None:
    """Writes `obj` to `path`. Refuses a path directly under `experiments/`,
    where the JAX package's tools keep their records."""
    path = os.path.abspath(path)
    if os.path.dirname(path) == os.path.join(REPO_ROOT, "experiments"):
        raise ValueError(f"{path}: experiments/*.json are the JAX "
                         f"package's records; write under {OUT_DIR}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)
    print("wrote", path, flush=True)


def key_paths(obj, prefix: str = "") -> set:
    """The key paths of a JSON value ('a/b/c'): a list contributes its
    elements' paths under 'a/[]', a key of digits stands as '#' (batch
    sizes keyed by value)."""
    if isinstance(obj, dict):
        out = set()
        for k, v in obj.items():
            k = "#" if str(k).isdigit() else str(k)
            p = f"{prefix}/{k}" if prefix else k
            out.add(p)
            out |= key_paths(v, p)
        return out
    if isinstance(obj, list):
        out = set()
        for v in obj:
            out |= key_paths(v, f"{prefix}/[]")
        return out
    return set()


def missing_keys(got, schema) -> list:
    """The key paths of `schema` (a JAX tool's JSON) that `got` lacks."""
    return sorted(key_paths(schema) - key_paths(got))


def load_schema(spec: str):
    """A JAX tool's JSON read as a schema: `spec` is a path under the repo
    root, with `#entry` for one entry of a history file."""
    path, _, entry = spec.partition("#")
    with open(os.path.join(REPO_ROOT, path)) as f:
        obj = json.load(f)
    return obj[entry] if entry else obj
