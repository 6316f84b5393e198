"""Cycle-mechanism probes, run at validation time (``--cycle_probes``; the
port of `cvc_tpu/evaluation/probes.py`).

Three teacher-forced diagnostics of why a cyclical run amplifies or pins
grounding, with no sampling:

* ``tf_attn_acc``: decoder attention (α) localization accuracy on GT
  sentences (the GT-sentence grounding mode).
* ``loc_acc``: localizer β localization accuracy on GT-word queries (the
  cycle's trained grounding head, measured directly).
* ``vhat_dependence``: reconstruction XE with a uniform (mean-region)
  v̂ minus the same XE with the learned β's v̂. Positive means the
  reconstructor uses word-aligned visual information; ~0 means the cycle's
  gradient path to the localizer carries no signal. The queries are the
  decode pass's argmax words.

All run under `torch.inference_mode`. With `mesh` (`parallel.mesh.Mesh`)
they run data-parallel over the data ranks, each on its rows of every
batch, with the one-process results on every rank; the parameters are the
whole tree.
"""

from __future__ import annotations

import numpy as np
import torch

from cvc_tpu_torch.data.pipeline import make_batches
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.ops.primitives import masked_xent


@torch.inference_mode()
def recon_loss(params, model_cfg, arrays, uniform: bool,
               mesh=None) -> torch.Tensor:
    """Reconstruction XE of the GT caption with context := v̂: the learned
    β's over the decode pass's argmax words, or (uniform) the mean of the
    live regions' encodings. With `mesh`, `arrays` are this rank's rows
    and the result is the whole batch's."""
    tokens, token_mask = arrays["tokens"], arrays["token_mask"]
    targets, mask = tokens[:, 1:], token_mask[:, 1:]
    v_enc, keys, v_global = core.encode_regions(
        params, model_cfg, arrays["feats"], arrays["box_geom"],
        arrays["region_cls"], arrays["region_mask"],
        arrays.get("global_feat"))
    emb_in = core.embed_tokens(params, tokens[:, :-1], torch.float32)
    h_seq, _, _ = core.decode(params, model_cfg, v_enc, keys, v_global,
                              emb_in, arrays["region_mask"])
    gen = torch.argmax(core.logits(params, h_seq), dim=-1).to(torch.int32)
    if uniform:
        m = arrays["region_mask"]
        vh1 = (v_enc * m[..., None]).sum(1) / torch.clamp(
            m.sum(1), min=1.0)[..., None]                        # [B, H]
        v_hat = vh1[:, None, :].expand(
            gen.shape[0], gen.shape[1], vh1.shape[-1]).to(v_enc.dtype)
    else:
        _, v_hat = core.localize(params, model_cfg, gen, v_enc,
                                 arrays["region_mask"])
    h_rec, _, _ = core.decode(params, model_cfg, v_enc, keys, v_global,
                              emb_in, arrays["region_mask"],
                              context_override=v_hat)
    if mesh is None:
        return masked_xent(core.logits(params, h_rec), targets, mask)
    part = masked_xent(core.logits(params, h_rec), targets, mask,
                       mesh.count(mask))
    return mesh.reduce_metrics({"xe": part})["xe"]


def vhat_dependence(params, model_cfg, ds, batch_size: int,
                    device="cuda", mesh=None) -> dict:
    """Mean recon XE (learned β vs uniform v̂) over a split. Raises without
    a GPU unless device="cpu"."""
    from cvc_tpu_torch.evaluation.evaluator import _rank_arrays
    device = resolve_device(device)
    ls, us = [], []
    for b in make_batches(ds, model_cfg, batch_size, shuffle=False,
                          prefetch=0, drop_last=False):
        arrays = _rank_arrays(b, device, mesh)
        ls.append(float(recon_loss(params, model_cfg, arrays, False, mesh)))
        us.append(float(recon_loss(params, model_cfg, arrays, True, mesh)))
    learned, uniform = float(np.mean(ls)), float(np.mean(us))
    return {"recon_xe_learned_beta": learned,
            "recon_xe_uniform_beta": uniform,
            "vhat_dependence": uniform - learned}


def cycle_probe_metrics(params, model_cfg, ds, batch_size: int,
                        device="cuda", mesh=None) -> dict:
    """The full probe bundle for one checkpoint or epoch (see the module
    doc). Raises without a GPU unless device="cpu"."""
    from cvc_tpu_torch.evaluation.evaluator import gt_sentence_attention_eval
    out = {}
    dec = gt_sentence_attention_eval(params, model_cfg, ds, batch_size,
                                     source="decoder", device=device,
                                     mesh=mesh)
    out["tf_attn_acc"] = dec.get("attn_accuracy", 0.0)
    loc = gt_sentence_attention_eval(params, model_cfg, ds, batch_size,
                                     source="localizer", device=device,
                                     mesh=mesh)
    out["loc_acc"] = loc.get("attn_accuracy", 0.0)
    out.update(vhat_dependence(params, model_cfg, ds, batch_size,
                               device=device, mesh=mesh))
    return out
