"""Split evaluation (the port of `cvc_tpu/evaluation/evaluator.py`):
generate captions on the device, score language and grounding on the host.

Each batch goes to the device through `data.pipeline.to_device`, is
decoded by `make_decoder` (greedy or beam, with the region attention
recorded, under `torch.inference_mode`), and its words are aligned with
their attention rows by `decode_sequence_with_pos`; the corpus metrics
are computed at the end. The localizer's β and the teacher-forced α also
run under `torch.inference_mode`, so parameters that require grad (a
`TrainState`'s) record no graph.

With `mesh` (`parallel.mesh.Mesh`) validation decodes data-parallel:
each data rank decodes its rows of every batch and the tokens and
attention rows are gathered over the data group in split order, so every
rank holds the predictions, and the scores, of a one-process run. The
parameters are the whole tree (`mesh.join_params`).
"""

from __future__ import annotations

import numpy as np
import torch

from cvc_tpu_torch.data.pipeline import make_batches, to_device
from cvc_tpu_torch.evaluation.grounding import (grounding_eval,
                                                gt_sentence_localization)
from cvc_tpu_torch.evaluation.language_eval import language_eval
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.cyclical import decode_teacher_forced
from cvc_tpu_torch.models.decoding import make_decoder
from cvc_tpu_torch.ops.dispatch import resolve_device


@torch.inference_mode()
def localizer_beta(params, model_cfg, arrays, tokens):
    """The localizer's β [B, L, S] over the words `tokens` [B, L] (the
    cycle's trained grounding head), for `grounding_source='localizer'`."""
    v_enc, _, _ = core.encode_regions(
        params, model_cfg, arrays["feats"], arrays["box_geom"],
        arrays["region_cls"], arrays["region_mask"],
        arrays.get("global_feat"))
    beta, _ = core.localize(params, model_cfg, tokens, v_enc,
                            arrays["region_mask"])
    return beta


@torch.inference_mode()
def teacher_forced_alphas(params, model_cfg, arrays):
    """The decoder's α [B, T - 1, S] with the GT caption teacher-forced
    (no dropout)."""
    _, alphas, _, _ = decode_teacher_forced(params, model_cfg, arrays)
    return alphas


def _rank_arrays(batch, device, mesh):
    """A host batch's model inputs on `device`: this rank's rows with
    `mesh`."""
    inputs = batch.model_inputs()
    if mesh is not None:
        inputs = mesh.shard_batch(inputs)
    return to_device(inputs, device)


def _whole(x, mesh):
    return x if mesh is None else mesh.gather_rows(x.contiguous())


def generate_split(params, model_cfg, eval_cfg, ds, batch_size: int,
                   generator=None, device="cuda", mesh=None):
    """Generate one caption per image. Returns (predictions,
    grounding_samples, references) ready for the scorers. With
    `sample_method='sample'` the draws come from `generator` (a
    torch.Generator on `device`; default seeded 0). With `mesh`, each data
    rank decodes its rows (see the module doc). Raises without a GPU
    unless device="cpu"."""
    device = resolve_device(device)
    decoder = make_decoder(model_cfg, eval_cfg, device)
    needs_generator = eval_cfg.sample_method == "sample"
    use_localizer = getattr(eval_cfg, "grounding_source",
                            "decoder") == "localizer"
    if needs_generator and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)

    predictions, samples, references = [], [], {}
    for batch in make_batches(ds, model_cfg, batch_size, shuffle=False,
                              drop_last=False, unique_images=True):
        arrays = _rank_arrays(batch, device, mesh)
        if needs_generator:
            draws = (generator if mesh is None else
                     mesh.row_draws(generator, arrays["feats"].shape[0]))
            out = decoder(params, arrays, draws)
        else:
            out = decoder(params, arrays)
        if use_localizer:
            alphas = localizer_beta(params, model_cfg, arrays,
                                    out["tokens"])
        else:
            alphas = out["alphas"]
        tokens = _whole(out["tokens"], mesh).cpu().numpy()
        alphas = _whole(alphas.float(), mesh).cpu().numpy()
        sents, word_pos = ds.vocab.decode_sequence_with_pos(tokens)
        for i in range(len(sents)):
            if not batch.valid[i]:
                continue
            ex = ds.get(int(batch.example_idx[i]))
            words = sents[i].split()
            predictions.append({"image_id": ex.image_id,
                                "caption": sents[i]})
            references[ex.image_id] = list(ex.captions)
            samples.append({
                "words": words,
                # exact word<->attention alignment: index alphas by each
                # emitted word's timestep (a skipped token, e.g. generated
                # BOS, must not shift subsequent rows)
                "attn": alphas[i, np.asarray(word_pos[i], np.int32)]
                if word_pos[i] else alphas[i, :0],
                "boxes": np.asarray(batch.box_geom[i][:, :4]),
                "gt": [{"class_id": e.class_id,
                        "box": np.asarray(e.box)} for e in ex.entities],
            })
    return predictions, samples, references


def evaluate_split(params, model_cfg, eval_cfg, ds, batch_size: int,
                   out_path: str | None = None, generator=None,
                   device="cuda", mesh=None) -> dict:
    """Full protocol: caption metrics + grounding F1 (+ GT-sentence mode
    when eval_cfg.gt_sentence_mode). With `mesh`, data-parallel; every
    rank returns the scores (writing `out_path` is rank 0's). Raises
    without a GPU unless device="cpu"."""
    predictions, samples, references = generate_split(
        params, model_cfg, eval_cfg, ds, batch_size, generator, device,
        mesh)
    if mesh is not None and mesh.rank != 0:
        out_path = None
    results = {}
    if eval_cfg.language_eval and predictions:
        results.update(language_eval(predictions, references,
                                     out_path=out_path))
    if eval_cfg.grounding_eval and samples:
        results.update(grounding_eval(samples, ds.class_names))
        results.pop("per_class", None)
    if eval_cfg.gt_sentence_mode:
        results.update(gt_sentence_attention_eval(
            params, model_cfg, ds, batch_size, device=device, mesh=mesh))
    results["n_images"] = len(predictions)
    return results


def gt_sentence_attention_eval(params, model_cfg, ds, batch_size: int,
                               source: str = "decoder",
                               device="cuda", mesh=None) -> dict:
    """Teacher-forced localization accuracy: run the decode pass on GT
    captions and check the attention at annotated word positions (the
    GT-sentence grounding mode). source='decoder' uses the generation
    attention α; 'localizer' uses the cycle-trained β over the GT words.
    With `mesh`, data-parallel as `generate_split`. Raises without a GPU
    unless device="cpu"."""
    device = resolve_device(device)
    samples = []
    for batch in make_batches(ds, model_cfg, batch_size, shuffle=False,
                              drop_last=False):
        arrays = _rank_arrays(batch, device, mesh)
        if source == "localizer":
            # β over the GT words w_1.. (positions align with word_idx)
            alphas = localizer_beta(params, model_cfg, arrays,
                                    arrays["tokens"][:, 1:])
        else:
            alphas = teacher_forced_alphas(params, model_cfg, arrays)
        alphas = _whole(alphas.float(), mesh).cpu().numpy()
        for i in range(alphas.shape[0]):
            if not batch.valid[i]:
                continue
            ex = ds.get(int(batch.example_idx[i]))
            ci = int(batch.caption_idx[i])
            gt = [{"word_idx": e.word_idx, "box": np.asarray(e.box)}
                  for e in ex.entities if e.caption_idx == ci]
            if gt:
                samples.append({"attn": alphas[i],
                                "boxes": np.asarray(batch.box_geom[i][:, :4]),
                                "gt": gt})
    return gt_sentence_localization(samples)
