"""Import reference-lineage PyTorch checkpoints (the port of
`cvc_tpu/models/torch_import.py`).

A user of the reference (the GVD-lineage cyclical captioner, whose
`main.py` writes `torch.save(model.state_dict(), ...)`) holds trained
`.pth` files. This module maps such a state_dict onto the port's
parameter tree (`models/core.init_params`' layout), so those checkpoints
are served and fine-tuned without retraining. The conversion is numpy
with the JAX package's rules, so both packages give the same arrays, bit
for bit:

  * Linear weights transpose ([out, in] -> [in, out]).
  * LSTMCell: `weight_ih`/`weight_hh` transpose; `bias_ih + bias_hh`
    fold into one bias. Gate order is i, f, g, o on both sides.
  * The att-LSTM's input blocks: the reference concatenates [h_lang,
    v_global, emb] ("hge"), the order of `core._split_wx_att`; other
    lineages are taken with `att_input_order`.
  * Additive attention: torch adds a bias in both branches of
    tanh(W_v v + b_v + W_h h + b_h); `attention.b` is their sum. The
    score projection's bias (`att_w.bias`) shifts every region's logit
    equally, which the softmax ignores: it is dropped and reported. The
    localizer follows the same pattern.
  * Vocabulary padding: the port's vocabulary is padded to a multiple of
    128; a smaller checkpoint vocabulary is zero-padded in `embed.table`
    and `logit.w`, and the padded `logit.b` entries are -1e9, so padding
    tokens are never generated.
  * What the checkpoint does not carry (the box-geometry projection, the
    detector-class embedding) is zero-filled, so its additive term
    vanishes; each is listed in the report.

Canonical key schema (after a DataParallel `module.` prefix is stripped):

    embed.weight                     [V, E]
    feat_proj.{weight,bias}          [H, D], [H]
    att_lstm.{weight_ih,weight_hh,bias_ih,bias_hh}
    att_h.{weight,bias}              [A, H], [A]     (query projection)
    att_v.{weight,bias}              [A, H], [A]     (key projection)
    att_w.{weight,bias}              [1, A], [1]     (score projection)
    lang_lstm.{...}
    logit.{weight,bias}              [V, H], [V]
    loc_q.{weight,bias}              [A, E], [A]     (localizer query)
    loc_v.{weight,bias}              [A, H], [A]     (localizer key)
    loc_w.{weight,bias}              [1, A], [1]
    global_proj.{weight,bias}        [H, G]  (optional segment feature)
    frame_emb.weight                 [F, H]  (optional temporal embedding)

The GVD / self-critical.pytorch names in `_ALIASES` and
`_ALIAS_PREFIXES` are accepted; anything else can be renamed first with
the `rename` map. Unmapped checkpoint keys are reported, never dropped
silently.
"""

from __future__ import annotations

import numpy as np
import torch

from cvc_tpu_torch.models.weights import load_params_npz, params_from_numpy
from cvc_tpu_torch.ops.dispatch import resolve_device

# alias -> canonical (exact match, after "module." is stripped)
_ALIASES = {
    "embed.0.weight": "embed.weight",
    "att_embed.0.weight": "feat_proj.weight",
    "att_embed.0.bias": "feat_proj.bias",
    "vis_embed.0.weight": "feat_proj.weight",
    "vis_embed.0.bias": "feat_proj.bias",
    "core.attention.h2att.weight": "att_h.weight",
    "core.attention.h2att.bias": "att_h.bias",
    "core.attention.alpha_net.weight": "att_w.weight",
    "core.attention.alpha_net.bias": "att_w.bias",
    "ctx2att.weight": "att_v.weight",
    "ctx2att.bias": "att_v.bias",
}
_ALIAS_PREFIXES = {
    "core.att_lstm.": "att_lstm.",
    "core.lang_lstm.": "lang_lstm.",
    "localizer.q.": "loc_q.",
    "localizer.v.": "loc_v.",
    "localizer.w.": "loc_w.",
    "global_enc.": "global_proj.",
}


def _canonicalize(sd: dict, rename: dict | None) -> dict:
    out = {}
    for k, v in sd.items():
        if k.startswith("module."):
            k = k[len("module."):]
        if rename and k in rename:
            k = rename[k]
        k = _ALIASES.get(k, k)
        for pre, rep in _ALIAS_PREFIXES.items():
            if k.startswith(pre):
                k = rep + k[len(pre):]
                break
        out[k] = np.asarray(v, dtype=np.float32)
    return out


def _lstm(sd, prefix, block_dims, block_order, our_order, used):
    """A torch LSTMCell as {"wx", "wh", "b"}, the input blocks of `wx`
    reordered from the checkpoint's `block_order` to `our_order` (symbols
    of `block_dims`, {symbol: width})."""
    wih = sd[prefix + "weight_ih"]          # [4H, sum(dims)]
    whh = sd[prefix + "weight_hh"]          # [4H, H]
    used.update({prefix + "weight_ih", prefix + "weight_hh"})
    b = np.zeros(wih.shape[0], np.float32)
    for suffix in ("bias_ih", "bias_hh"):
        if prefix + suffix in sd:
            b = b + sd[prefix + suffix]
            used.add(prefix + suffix)
    blocks, off = {}, 0
    for sym in block_order:
        d = block_dims[sym]
        blocks[sym] = wih[:, off:off + d]
        off += d
    if off != wih.shape[1]:
        raise ValueError(
            f"{prefix}weight_ih input dim {wih.shape[1]} != expected "
            f"{off} (blocks {block_dims}, order {block_order!r})")
    wx = np.concatenate([blocks[s] for s in our_order], axis=1).T
    return {"wx": np.ascontiguousarray(wx),
            "wh": np.ascontiguousarray(whh.T),
            "b": b}


def _pad_rows(a: np.ndarray, rows: int, fill: float = 0.0) -> np.ndarray:
    if a.shape[0] == rows:
        return a
    out = np.full((rows,) + a.shape[1:], fill, np.float32)
    out[: a.shape[0]] = a
    return out


def convert_state_dict(state_dict: dict, cfg, rename: dict | None = None,
                       att_input_order: str = "hge", device="cuda"):
    """Map a reference-lineage torch state_dict onto the port's parameter
    tree for ModelConfig `cfg`.

    state_dict: {name: tensor or array}. rename: {checkpoint key:
    canonical key}, applied before the aliases. att_input_order: the
    checkpoint att-LSTM's input order over h = h_lang, g = v_global, e =
    the word embedding (the reference: "hge").

    Returns (params, report): float32 tensors on `device` in
    `init_params`' layout, and the report's lists mapped / zero_filled /
    dropped (softmax-invariant) / unmapped with ckpt_vocab and
    padded_vocab. Raises ValueError on a shape mismatch and on
    `cfg.obj_interact` (the checkpoint carries no region transformer);
    raises without a GPU unless device="cpu"."""
    device = resolve_device(device)
    sd = _canonicalize(state_dict, rename)
    used: set = set()
    report = {"mapped": [], "zero_filled": [], "dropped": [], "unmapped": []}

    H, E, A = cfg.rnn_size, cfg.input_encoding_size, cfg.att_hid_size
    V, D = cfg.vocab_size, cfg.feat_dim

    def take(key, shape=None):
        a = sd[key]
        used.add(key)
        if shape is not None and tuple(a.shape) != tuple(shape):
            raise ValueError(f"{key}: checkpoint shape {a.shape} != "
                             f"expected {shape} for this ModelConfig")
        return a

    def bias(key, n):
        return sd.get(key, np.zeros(n, np.float32))

    emb = take("embed.weight")
    if emb.shape[1] != E:
        raise ValueError(f"embed.weight dim {emb.shape[1]} != "
                         f"input_encoding_size {E}")
    ckpt_v = emb.shape[0]
    if ckpt_v > V:
        raise ValueError(f"checkpoint vocab {ckpt_v} > cfg.vocab_size {V}; "
                         f"raise vocab_size (pad to a multiple of 128)")

    logit_w = take("logit.weight", (ckpt_v, H))
    logit_b = take("logit.bias", (ckpt_v,))

    if cfg.obj_interact:
        raise ValueError("cfg.obj_interact=True but torch obj_interact "
                         "weights are not supported by the importer; "
                         "import with obj_interact=False")

    # init_params' key order, every leaf from the checkpoint or zeros
    C = cfg.class_emb_dim
    params = {
        "embed": {"table": _pad_rows(emb, V)},
        "region_enc": {
            "feat_w": np.ascontiguousarray(
                take("feat_proj.weight", (H, D)).T),
            "geom_w": np.zeros((5, H), np.float32),
            "cls_emb": np.zeros((cfg.num_classes, C), np.float32),
            "cls_w": np.zeros((C, H), np.float32),
            "b": (take("feat_proj.bias", (H,)) if "feat_proj.bias" in sd
                  else np.zeros(H, np.float32)),
        },
        "att_lstm": _lstm(sd, "att_lstm.", {"h": H, "g": H, "e": E},
                          att_input_order, "hge", used),
        "attention": {
            "wv": np.ascontiguousarray(take("att_v.weight", (A, H)).T),
            "wh": np.ascontiguousarray(take("att_h.weight", (A, H)).T),
            "w": take("att_w.weight", (1, A))[0],
            "b": bias("att_h.bias", A) + bias("att_v.bias", A),
        },
        "lang_lstm": _lstm(sd, "lang_lstm.", {"c": H, "a": H},
                           "ca", "ca", used),
        "logit": {"w": np.ascontiguousarray(_pad_rows(logit_w, V).T),
                  "b": _pad_rows(logit_b, V, fill=-1e9)},
        "localizer": {
            "wq": np.ascontiguousarray(take("loc_q.weight", (A, E)).T),
            "wv": np.ascontiguousarray(take("loc_v.weight", (A, H)).T),
            "w": take("loc_w.weight", (1, A))[0],
            "b": bias("loc_q.bias", A) + bias("loc_v.bias", A),
        },
    }
    for opt in ("att_h.bias", "att_v.bias", "loc_q.bias", "loc_v.bias"):
        if opt in sd:
            used.add(opt)
    for drop in ("att_w.bias", "loc_w.bias"):
        if drop in sd:
            used.add(drop)
            report["dropped"].append(f"{drop} (softmax-invariant shift)")
    for z in ("geom_w", "cls_w", "cls_emb"):
        report["zero_filled"].append(f"region_enc.{z}")

    if cfg.global_feat_dim:
        G = cfg.global_feat_dim
        if "global_proj.weight" in sd:
            params["global_enc"] = {
                "w": np.ascontiguousarray(
                    take("global_proj.weight", (H, G)).T),
                "b": (take("global_proj.bias", (H,))
                      if "global_proj.bias" in sd
                      else np.zeros(H, np.float32)),
            }
        else:
            params["global_enc"] = {"w": np.zeros((G, H), np.float32),
                                    "b": np.zeros(H, np.float32)}
            report["zero_filled"].append("global_enc (checkpoint has no "
                                         "global_proj; v_global will be 0)")
    if cfg.num_frames > 1:
        if "frame_emb.weight" in sd:
            params["frame_emb"] = {
                "table": take("frame_emb.weight", (cfg.num_frames, H))}
        else:
            params["frame_emb"] = {
                "table": np.zeros((cfg.num_frames, H), np.float32)}
            report["zero_filled"].append("frame_emb")

    report["mapped"] = sorted(used)
    report["unmapped"] = sorted(set(sd) - used)
    report["ckpt_vocab"] = int(ckpt_v)
    report["padded_vocab"] = int(V)
    params = _float32(params)
    return params_from_numpy(params, device), report


def _float32(tree):
    if isinstance(tree, dict):
        return {k: _float32(v) for k, v in tree.items()}
    return np.ascontiguousarray(tree, np.float32)


def load_torch_state_dict(path: str) -> dict:
    """A .pth/.pt checkpoint as {name: np.ndarray}. Takes a bare
    state_dict or the wrappers {"model" | "state_dict" |
    "model_state_dict": sd}; entries without a shape are skipped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    for key in ("model", "state_dict", "model_state_dict"):
        if isinstance(obj, dict) and key in obj and isinstance(obj[key], dict):
            obj = obj[key]
            break
    if not isinstance(obj, dict):
        raise ValueError(f"{path}: not a state_dict (got {type(obj)})")
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach") else v
            for k, v in obj.items()
            if hasattr(v, "shape")}


def import_params(path: str, cfg, rename: dict | None = None,
                  att_input_order: str = "hge", device="cuda"):
    """(params, report) from a .pth/.pt (converted) or an .npz (the flat
    `a/b/c` layout, taken as it is), on `device`. Raises without a GPU
    unless device="cpu"."""
    device = resolve_device(device)
    if path.endswith(".npz"):
        return (load_params_npz(path, device),
                {"mapped": ["<npz passthrough>"]})
    return convert_state_dict(load_torch_state_dict(path), cfg,
                              rename=rename, att_input_order=att_input_order,
                              device=device)
