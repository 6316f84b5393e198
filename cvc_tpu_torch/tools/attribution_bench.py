"""Where the decode and train milliseconds go, by measured decomposition on
the card (the twin of `tools/attribution_bench.py`, with its flags and
the keys of its JSON). Each suspected consumer is timed alone, chained
where the JAX tool chains it (outputs feed the next call's inputs), and
set against its bounds on the H100: `mxu_bound_ms` (the key the JAX tool
writes) is its analytic FLOPs over the card's dense peak for the model's
type, `hbm_bound_ms` its bytes over 3.35 TB/s.

  decode/full_beam5         the beam-5 decoder (kernels on the card)
  decode/encode_regions     region projection + attention keys
  decode/vocab_head_x21     L chained [B*K, H] x [H, V] head products
  decode/softmax_topk_x21   L chained selects of the beam step (the top-k +
                            logsumexp kernel on the card, which reads the
                            logits once)
  decode/beam_scan_V128     the beam decode with a 128-word head: the scan
                            minus the head's cost
  with --train:
  train/full_cyclical_step  the train step (backward kernels, clip, Adam)
  train/forward_only        the cyclical loss, no gradient
  train/forward_decode_only the loss without the cycle
  train/grad_decode_only    its gradient (forward + backward, no cycle)

Each is the best of 3 windows of --iters calls, the card waited for at
the end of each window; every window is printed.

    python -m cvc_tpu_torch.tools.attribution_bench [--batch 64] \
        [--iters 10] [--train] [--tiny] [--dtype bfloat16] \
        [--out experiments/h100/attribution_b<B>.json]

Writes --out (never the JAX tool's experiments/attribution_b*.json).
--tiny shrinks the widths (benchlib.TINY, float32 like the JAX tool's
--tiny), and does not choose the device: `main(argv, device="cpu")`
runs on the CPU, the default on CUDA.
"""

import argparse
import dataclasses
import json

import torch

from cvc_tpu_torch.config import EvalConfig, TrainConfig
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.cyclical import cyclical_loss
from cvc_tpu_torch.models.decoding import make_decoder, top_k_lowest_index
from cvc_tpu_torch.ops import dispatch
from cvc_tpu_torch.ops.kernels import fused_topk_lse
from cvc_tpu_torch.tools.benchlib import (BEAM, HBM_BYTES_PER_S, PEAK_OPS,
                                          SEQ, TINY, caption_flops, card,
                                          decoder_params, flagship_config,
                                          out_path, random_arrays,
                                          time_windows, train_image_flops,
                                          write_json)
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.step import make_train_step
from cvc_tpu_torch.training.train_state import TrainState, tree_items

SCHEMA = "experiments/attribution_b64.json"


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny widths (a check of the harness)")
    ap.add_argument("--dtype", default="bfloat16",
                    help="activation dtype; the serving default is bf16")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    device = dispatch.resolve_device(device)

    B = a.batch
    cfg = (flagship_config(**TINY) if a.tiny
           else flagship_config(dtype=a.dtype, use_pallas=None))
    peak = PEAK_OPS[cfg.dtype]
    params = core.init_params(torch.Generator().manual_seed(0), cfg, device)
    dparams = decoder_params(cfg, params)
    arrays = random_arrays(cfg, B, device=device)
    rows = []

    def timed(fn, name):
        return min(time_windows(fn, device, a.iters, label=name))

    def add(name, sec, flops=None, bytes_=None, note=""):
        row = {"name": name, "ms": sec * 1e3}
        if flops:
            row["mxu_bound_ms"] = flops / peak * 1e3
        if bytes_:
            row["hbm_bound_ms"] = bytes_ / HBM_BYTES_PER_S * 1e3
        row["note"] = note
        rows.append(row)
        print(json.dumps(row), flush=True)

    H, A, V = cfg.rnn_size, cfg.att_hid_size, cfg.vocab_size
    S, D = cfg.total_regions, cfg.feat_dim
    L = SEQ + 1
    R = B * BEAM                     # beam-folded rows
    dtype = core.compute_dtype(cfg)
    esize = torch.finfo(dtype).bits // 8

    # ---- full beam decode ------------------------------------------------
    e_cfg = EvalConfig(beam_size=BEAM, max_length=SEQ, sample_method="beam")
    dec = make_decoder(cfg, e_cfg, device)
    t = timed(lambda: dec(dparams, arrays), "decode/full_beam5")
    add("decode/full_beam5", t, flops=B * caption_flops(cfg, BEAM),
        note=f"caps/s={B / t:.0f}")

    # ---- encode ----------------------------------------------------------
    def enc():
        with torch.no_grad():
            return core.encode_regions(
                dparams, cfg, arrays["feats"], arrays["box_geom"],
                arrays["region_cls"], arrays["region_mask"],
                arrays.get("global_feat"))[0]
    t = timed(enc, "decode/encode_regions")
    add("decode/encode_regions", t,
        flops=B * (2 * S * D * H + 2 * S * H * A),
        bytes_=B * S * D * 4, note="region proj + keys")

    # ---- vocab head alone (a chain of L products) ------------------------
    w = params["logit"]["w"].to(dtype)
    b0 = params["logit"]["b"].float()
    h0 = torch.ones((R, H), dtype=dtype, device=device)

    def head_chain():
        h = h0
        for _ in range(L):
            logits = (h @ w).float() + b0
            # feed a slice of the output back so each step depends on the
            # last
            h = h + (logits[:, :H] * 1e-6).to(dtype)
        return h
    t = timed(head_chain, "decode/vocab_head_x21")
    add("decode/vocab_head_x21", t, flops=L * 2 * R * H * V,
        bytes_=L * (esize * H * V + R * V * 4),
        note=f"[{R},{H}]x[{H},{V}] per step")

    # ---- the beam step's select alone ------------------------------------
    select = dispatch.use_pallas_select(cfg, device)
    x0 = torch.zeros((R, V), dtype=torch.float32, device=device)

    def select_chain():
        x = x0
        for _ in range(L):
            if select:
                v1, _, lse = fused_topk_lse(x, BEAM)
            else:
                v1, _ = top_k_lowest_index(x, BEAM)
                lse = torch.logsumexp(x, dim=-1)
            lp1 = v1 - lse[:, None]
            x = x + lp1.sum(-1, keepdim=True) * 1e-9
        return x
    t = timed(select_chain, "decode/softmax_topk_x21")
    add("decode/softmax_topk_x21", t, bytes_=L * R * V * 4,
        note="per-beam top-k + logsumexp (" + ("the kernel" if select
                                               else "plain") + ")")

    # ---- beam scan minus vocab head (a 128-column head) ------------------
    cfg_small = dataclasses.replace(cfg, vocab_size=128)
    p_small = dict(dparams)
    p_small["logit"] = {"w": dparams["logit"]["w"][:, :128].contiguous(),
                        "b": dparams["logit"]["b"][:128].contiguous()}
    dec_small = make_decoder(cfg_small, e_cfg, device)
    t = timed(lambda: dec_small(p_small, arrays), "decode/beam_scan_V128")
    add("decode/beam_scan_V128", t,
        note="full beam decode with a 128-col head: scan minus head cost")

    if a.train:
        tc = TrainConfig(learning_rate=5e-4, grad_clip=0.1)
        tparams = core.init_params(torch.Generator().manual_seed(0), cfg,
                                   device)
        state = TrainState.create(tparams, make_optimizer(tc, 1000))
        step = make_train_step(cfg, tc, 1000, device)
        gen = torch.Generator(device=device).manual_seed(0)
        t = timed(lambda: step(state, arrays, gen),
                  "train/full_cyclical_step")
        add("train/full_cyclical_step", t,
            flops=B * train_image_flops(cfg), note=f"imgs/s={B / t:.0f}")

        def fwd(cycle):
            with torch.no_grad():
                return cyclical_loss(params, cfg, arrays, generator=None,
                                     train=False, enable_cycle=cycle)[0]
        t = timed(lambda: fwd(True), "train/forward_only")
        add("train/forward_only", t, flops=B * train_image_flops(cfg) / 3)
        t = timed(lambda: fwd(False), "train/forward_decode_only")
        add("train/forward_decode_only", t)

        leaves = [p for _, p in tree_items(params)]
        for p in leaves:
            p.requires_grad_(True)

        def grad_nocycle():
            loss, _ = cyclical_loss(params, cfg, arrays, generator=None,
                                    train=False, enable_cycle=False)
            return torch.autograd.grad(loss, leaves, allow_unused=True)
        t = timed(grad_nocycle, "train/grad_decode_only")
        add("train/grad_decode_only", t, note="fwd+bwd, no cycle")

    out = {"batch": B, "beam": BEAM, "dtype": cfg.dtype, **card(device),
           "rows": rows}
    write_json(a.out or out_path(f"attribution_b{B}.json"), out)
    return out


if __name__ == "__main__":
    main()
