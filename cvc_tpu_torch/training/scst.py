"""Self-critical sequence training (SCST), the lineage's second training
stage (the port of `cvc_tpu/training/scst.py`):

  device:  sample a caption per image at a temperature, and its greedy
           baseline (`make_scst_sampler`);
  host:    CIDEr-D rewards of both with the training corpus's document
           frequency (`ScstRewarder`); advantage = r_sample - r_greedy;
  device:  policy-gradient step: teacher-force the sampled tokens through
           the decoder for their logprobs and minimize
           -sum(advantage * logp * mask) / max(sum(mask), 1)
           (`make_scst_step`), optionally blended with the cyclical XE.

On CUDA the sampled decode runs the LSTM gates and attention forward
kernels, the greedy baseline those and the top-k select at k 1, and the
step the stacked scan (`core.decode`) with its backward kernels, and, with
`xe_weight > 0`, the cyclical loss's kernels. The resident variants
(`make_resident_scst_sampler`, `make_scst_step(..., resident=True)`,
`scst_train_batch_resident`) gather each batch from a `DeviceDataset` on
the device. The JAX package's `mesh` arguments wait for multi-GPU
support.
"""

from __future__ import annotations

import numpy as np
import torch

from cvc_tpu_torch.data.vocab import BOS_ID, EOS_ID, PAD_ID
from cvc_tpu_torch.evaluation.cider import CiderDFast
from cvc_tpu_torch.evaluation.tokenizer import ptb_tokenize
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.cyclical import cyclical_loss
from cvc_tpu_torch.models.decoding import greedy_decode
from cvc_tpu_torch.ops.dispatch import require_fit, resolve_device
from cvc_tpu_torch.training.optimizer import make_optimizer


def make_scst_sampler(model_cfg, max_len: int, temperature: float = 1.0,
                      device="cuda"):
    """fn(params, arrays, generator) -> dict(sample_tokens, greedy_tokens),
    each int32 [B, max_len + 1]: a caption sampled at `temperature` with
    draws from `generator` (a torch.Generator on `device`), and the
    argmax caption (at temperature 1). No gradient is recorded. Raises
    without a GPU unless device="cpu", and raises ValueError where the
    greedy path's kernels do not take model_cfg's widths."""
    require_fit(model_cfg, resolve_device(device), "greedy")

    @torch.no_grad()
    def fn(params, arrays, generator):
        s = greedy_decode(params, model_cfg, arrays, max_len,
                          temperature=temperature, sample=True,
                          generator=generator)
        g = greedy_decode(params, model_cfg, arrays, max_len)
        return {"sample_tokens": s["tokens"], "greedy_tokens": g["tokens"]}

    return fn


def make_resident_scst_sampler(model_cfg, max_len: int,
                               temperature: float = 1.0, device="cuda"):
    """fn(params, data, idx, generator) -> dict(sample_tokens,
    greedy_tokens): `make_scst_sampler` on the batch of pairs `idx` [B]
    (int64 on the device) gathered from `DeviceDataset.data`
    (`gather_batch`). Raises as make_scst_sampler does."""
    from cvc_tpu_torch.data.device_data import gather_batch
    sampler = make_scst_sampler(model_cfg, max_len, temperature, device)

    def fn(params, data, idx, generator):
        return sampler(params, gather_batch(data, idx), generator)

    return fn


def sample_mask(tokens: torch.Tensor) -> torch.Tensor:
    """Supervision mask over a generated buffer: the words and the first
    EOS, float32."""
    is_eos = (tokens == EOS_ID).to(torch.int32)
    after_eos = torch.cumsum(is_eos, dim=1) - is_eos
    return ((tokens != PAD_ID) & (after_eos == 0)).to(torch.float32)


def policy_gradient_loss(params, model_cfg, arrays, sample_tokens,
                         advantage):
    """The REINFORCE loss of given sampled tokens [B, L] and advantages
    [B]: the tokens teacher-forced through `core.decode` (BOS +
    sampled[:-1] in, sampled out), logp from log_softmax of the float32
    logits, -sum(advantage * logp * mask) / max(sum(mask), 1) with
    `sample_mask`. Returns (loss, metrics {loss_pg, advantage_mean,
    sample_len})."""
    B = sample_tokens.shape[0]
    dtype = core.compute_dtype(model_cfg)
    v_enc, keys, v_global = core.encode_regions(
        params, model_cfg, arrays["feats"], arrays["box_geom"],
        arrays["region_cls"], arrays["region_mask"],
        arrays.get("global_feat"))
    bos = torch.full((B, 1), BOS_ID, dtype=sample_tokens.dtype,
                     device=sample_tokens.device)
    inputs = torch.cat([bos, sample_tokens[:, :-1]], dim=1)
    emb = core.embed_tokens(params, inputs, dtype)
    h_seq, _, _ = core.decode(params, model_cfg, v_enc, keys, v_global, emb,
                              arrays["region_mask"])
    logp = torch.log_softmax(core.logits(params, h_seq), dim=-1)
    tok_lp = logp.gather(-1, sample_tokens.long()[..., None])[..., 0]
    mask = sample_mask(sample_tokens)
    pg = (-(advantage[:, None] * tok_lp * mask).sum()
          / torch.clamp(mask.sum(), min=1.0))
    metrics = {"loss_pg": pg, "advantage_mean": advantage.mean(),
               "sample_len": mask.sum(dim=1).mean()}
    return pg, metrics


def make_scst_step(model_cfg, train_cfg, steps_per_epoch: int,
                   xe_weight: float = 0.0, enable_cycle: bool | None = None,
                   device="cuda", resident: bool = False):
    """step(state, arrays, sample_tokens, advantage, generator=None) ->
    metrics: one policy-gradient update of the `TrainState` in place
    (`policy_gradient_loss`; no gradient flows through the sampling).
    `xe_weight > 0` adds that much of the cyclical XE loss, its cycle
    staged by `enable_cycle` (default train_cfg.enable_cycle) and its
    dropout drawn from `generator` (None: no dropout). The metrics are
    0-d device tensors: loss, loss_pg, advantage_mean, sample_len[,
    loss_xe]. With `resident=True` the step is step(state, data, idx,
    sample_tokens, advantage, generator=None) and gathers the batch of
    pairs `idx` [B] (int64 on the device) from `DeviceDataset.data`.
    Raises without a GPU unless device="cpu", and raises ValueError where
    the training kernels do not take model_cfg's widths."""
    require_fit(model_cfg, resolve_device(device), "train")
    optimizer = make_optimizer(train_cfg, steps_per_epoch)
    if enable_cycle is None:
        enable_cycle = train_cfg.enable_cycle

    def step(state, arrays: dict, sample_tokens, advantage,
             generator=None) -> dict:
        leaves = state.leaves
        for p in leaves:
            p.grad = None
        loss, metrics = policy_gradient_loss(state.params, model_cfg, arrays,
                                             sample_tokens, advantage)
        if xe_weight > 0:
            xe, _ = cyclical_loss(state.params, model_cfg, arrays,
                                  generator=generator, train=True,
                                  enable_cycle=enable_cycle)
            loss = loss + xe_weight * xe
            metrics["loss_xe"] = xe
        metrics["loss"] = loss
        loss.backward()
        optimizer.update(state.opt, leaves, state.step)
        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    if resident:
        from cvc_tpu_torch.data.device_data import gather_batch

        def resident_step(state, data: dict, idx, sample_tokens, advantage,
                          generator=None) -> dict:
            return step(state, gather_batch(data, idx), sample_tokens,
                        advantage, generator)

        return resident_step
    return step


class ScstRewarder:
    """Host-side CIDEr-D reward with the training corpus's document
    frequency."""

    def __init__(self, train_references: dict[str, list[str]]):
        # every training reference tokenized once: rewards() runs every
        # batch
        self._ref_cache = {
            img: [" ".join(ptb_tokenize(r)) for r in refs]
            for img, refs in train_references.items()}
        self.scorer = CiderDFast(corpus_refs=list(self._ref_cache.values()))

    def _refs_tok(self, image_id: str, raw: list[str]) -> list[str]:
        got = self._ref_cache.get(image_id)
        if got is None:     # an image outside the corpus: cache it too
            got = [" ".join(ptb_tokenize(r)) for r in raw]
            self._ref_cache[image_id] = got
        return got

    def rewards(self, vocab, tokens: np.ndarray, image_ids: list[str],
                references: dict[str, list[str]]) -> np.ndarray:
        """CIDEr-D of each row of `tokens` [B, L] (host numpy) against its
        image's references; float32 [B]."""
        sents = vocab.decode_sequence(tokens)
        cands = {f"c{i}": " ".join(ptb_tokenize(s))
                 for i, s in enumerate(sents)}
        refs = {f"c{i}": self._refs_tok(image_ids[i],
                                        references[image_ids[i]])
                for i in range(len(sents))}
        _, per = self.scorer.compute_score(cands, refs)
        return np.asarray([per[f"c{i}"] for i in range(len(sents))],
                          np.float32)


def scst_train_batch(state, arrays, batch, ds, sampler, step_fn, rewarder,
                     sample_generator, step_generator=None) -> dict:
    """One SCST iteration (sample -> reward -> update) on a batch:
    `arrays` are the batch's model inputs on the device
    (`data.pipeline.to_device`), `batch` its host `Batch`. The draws of
    the sampling come from `sample_generator` and the XE blend's dropout
    from `step_generator`, two generators, so the two do not correlate.
    Updates `state` in place; returns the step's metrics with
    reward_sample and reward_greedy (host floats) added."""
    out = sampler(state.params, arrays, sample_generator)
    sample_tokens = out["sample_tokens"]
    tokens = torch.stack([sample_tokens, out["greedy_tokens"]]).cpu().numpy()
    image_ids = [ds.get(int(i)).image_id for i in batch.example_idx]
    references = {ds.get(int(i)).image_id: ds.get(int(i)).captions
                  for i in batch.example_idx}
    r_s = rewarder.rewards(ds.vocab, tokens[0], image_ids, references)
    r_g = rewarder.rewards(ds.vocab, tokens[1], image_ids, references)
    advantage = torch.from_numpy(
        (r_s - r_g) * np.asarray(batch.valid, np.float32)).to(
            sample_tokens.device)
    metrics = dict(step_fn(state, arrays, sample_tokens, advantage,
                           step_generator))
    metrics["reward_sample"] = float(r_s.mean())
    metrics["reward_greedy"] = float(r_g.mean())
    return metrics


def scst_train_batch_resident(state, dd, idx, ds, sampler, step_fn,
                              rewarder, sample_generator,
                              step_generator=None) -> dict:
    """One SCST iteration over a `DeviceDataset` `dd`: `idx` is the batch's
    [B] pair-index array (host numpy), `sampler` a
    `make_resident_scst_sampler` and `step_fn` a `make_scst_step(...,
    resident=True)`. The per-step uploads are the index vector and the [B]
    advantage; the sampled tokens visit the host for the CIDEr-D reward.
    The two generators split as in `scst_train_batch`. Updates `state` in
    place; returns the step's metrics with reward_sample and reward_greedy
    added."""
    idx_dev = dd.upload_index(idx)
    out = sampler(state.params, dd.data, idx_dev, sample_generator)
    sample_tokens = out["sample_tokens"]
    tokens = torch.stack([sample_tokens, out["greedy_tokens"]]).cpu().numpy()
    ex_ids = dd.example_ids(idx)
    image_ids = [ds.get(e).image_id for e in ex_ids]
    references = {ds.get(e).image_id: ds.get(e).captions for e in ex_ids}
    r_s = rewarder.rewards(ds.vocab, tokens[0], image_ids, references)
    r_g = rewarder.rewards(ds.vocab, tokens[1], image_ids, references)
    advantage = torch.from_numpy(r_s - r_g).to(sample_tokens.device)
    metrics = dict(step_fn(state, dd.data, idx_dev, sample_tokens, advantage,
                           step_generator))
    metrics["reward_sample"] = float(r_s.mean())
    metrics["reward_greedy"] = float(r_g.mean())
    return metrics
