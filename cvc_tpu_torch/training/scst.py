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
the device.

With `mesh` (`parallel.mesh.Mesh`) each data rank samples and updates on
its rows of the batch: the sampler decodes with the whole head and draws
for the whole batch, keeping its rows; the host reward is computed by each
rank on its own images; the step is data-parallel as
`training.step.make_train_step(mesh=)` (global token counts, gradients
summed over the data group, the head split over the model group).
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
from cvc_tpu_torch.training.step import apply_update, rank_inputs


def make_scst_sampler(model_cfg, max_len: int, temperature: float = 1.0,
                      device="cuda", mesh=None):
    """fn(params, arrays, generator) -> dict(sample_tokens, greedy_tokens),
    each int32 [B, max_len + 1]: a caption sampled at `temperature` with
    draws from `generator` (a torch.Generator on `device`), and the
    argmax caption (at temperature 1). No gradient is recorded. With
    `mesh`, `params` is the rank's view (the head is joined for the
    decode), `arrays` its rows, and the draws are made for the whole
    batch. Raises without a GPU unless device="cpu", and raises
    ValueError where the greedy path's kernels do not take model_cfg's
    widths."""
    require_fit(model_cfg, resolve_device(device), "greedy")

    @torch.no_grad()
    def fn(params, arrays, generator):
        if mesh is not None:
            params = mesh.join_params(params)
            generator = mesh.row_draws(generator, arrays["feats"].shape[0])
        s = greedy_decode(params, model_cfg, arrays, max_len,
                          temperature=temperature, sample=True,
                          generator=generator)
        g = greedy_decode(params, model_cfg, arrays, max_len)
        return {"sample_tokens": s["tokens"], "greedy_tokens": g["tokens"]}

    return fn


def make_resident_scst_sampler(model_cfg, max_len: int,
                               temperature: float = 1.0, device="cuda",
                               mesh=None):
    """fn(params, data, idx, generator) -> dict(sample_tokens,
    greedy_tokens): `make_scst_sampler` on the batch of pairs `idx` [B]
    (int64 on the device) gathered from `DeviceDataset.data`
    (`gather_batch`; with `mesh`, a `ShardedDeviceDataset`'s shard and
    the rank's local ids). Raises as make_scst_sampler does."""
    from cvc_tpu_torch.data.device_data import gather_batch
    sampler = make_scst_sampler(model_cfg, max_len, temperature, device,
                                mesh)

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
                         advantage, mesh=None):
    """The REINFORCE loss of given sampled tokens [B, L] and advantages
    [B]: the tokens teacher-forced through `core.decode` (BOS +
    sampled[:-1] in, sampled out), logp from log_softmax of the float32
    logits, -sum(advantage * logp * mask) / max(sum(mask), 1) with
    `sample_mask`. Returns (loss, metrics {loss_pg, advantage_mean,
    sample_len}). With `mesh` the sums and means are over the whole batch
    (this rank's share, as `cyclical_loss(mesh=)`)."""
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
    if mesh is None:
        n_tok = mask.sum()
        adv_mean, sample_len = advantage.mean(), mask.sum(dim=1).mean()
    else:                    # this rank's share of the whole batch's means
        n_tok = mesh.count(mask)
        adv_mean = advantage.sum() / (B * mesh.data)
        sample_len = mask.sum() / (B * mesh.data)
    pg = (-(advantage[:, None] * tok_lp * mask).sum()
          / torch.clamp(n_tok, min=1.0))
    metrics = {"loss_pg": pg, "advantage_mean": adv_mean,
               "sample_len": sample_len}
    return pg, metrics


def make_scst_step(model_cfg, train_cfg, steps_per_epoch: int,
                   xe_weight: float = 0.0, enable_cycle: bool | None = None,
                   device="cuda", resident: bool = False, mesh=None):
    """step(state, arrays, sample_tokens, advantage, generator=None) ->
    metrics: one policy-gradient update of the `TrainState` in place
    (`policy_gradient_loss`; no gradient flows through the sampling).
    `xe_weight > 0` adds that much of the cyclical XE loss, its cycle
    staged by `enable_cycle` (default train_cfg.enable_cycle) and its
    dropout drawn from `generator` (None: no dropout). The metrics are
    0-d device tensors: loss, loss_pg, advantage_mean, sample_len[,
    loss_xe]. With `resident=True` the step is step(state, data, idx,
    sample_tokens, advantage, generator=None) and gathers the batch of
    pairs `idx` [B] (int64 on the device) from `DeviceDataset.data`. With
    `mesh`, the step is a data-parallel rank's (see the module doc).
    Raises without a GPU unless device="cpu", and raises ValueError where
    the training kernels do not take model_cfg's widths."""
    require_fit(model_cfg, resolve_device(device), "train")
    optimizer = make_optimizer(train_cfg, steps_per_epoch)
    if enable_cycle is None:
        enable_cycle = train_cfg.enable_cycle

    def step(state, arrays: dict, sample_tokens, advantage,
             generator=None) -> dict:
        for p in state.leaves:
            p.grad = None
        params, gen = rank_inputs(mesh, state.params, generator,
                                  sample_tokens.shape[0])
        loss, metrics = policy_gradient_loss(params, model_cfg, arrays,
                                             sample_tokens, advantage, mesh)
        if xe_weight > 0:
            xe, _ = cyclical_loss(params, model_cfg, arrays,
                                  generator=gen, train=True,
                                  enable_cycle=enable_cycle, mesh=mesh)
            loss = loss + xe_weight * xe
            metrics["loss_xe"] = xe
        metrics["loss"] = loss
        loss.backward()
        apply_update(state, optimizer, mesh)
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        return metrics if mesh is None else mesh.reduce_metrics(metrics)

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


def _reward_means(r_s, r_g, mesh) -> tuple:
    """The batch's mean rewards: with `mesh`, over the whole batch (each
    rank scored its own rows)."""
    if mesh is None or mesh.data_group is None:
        return float(r_s.mean()), float(r_g.mean())
    import torch.distributed as dist
    t = torch.tensor([float(r_s.sum()), float(r_g.sum()), float(len(r_s))],
                     dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, group=mesh.data_group)
    return float(t[0] / t[2]), float(t[1] / t[2])


def scst_train_batch(state, arrays, batch, ds, sampler, step_fn, rewarder,
                     sample_generator, step_generator=None,
                     mesh=None) -> dict:
    """One SCST iteration (sample -> reward -> update) on a batch:
    `arrays` are the batch's model inputs on the device
    (`data.pipeline.to_device`), `batch` its host `Batch`. The draws of
    the sampling come from `sample_generator` and the XE blend's dropout
    from `step_generator`, two generators, so the two do not correlate.
    With `mesh` (the sampler and step made with it), `arrays` are this
    rank's rows of the host `batch`, which it scores on its own. Updates
    `state` in place; returns the step's metrics with reward_sample and
    reward_greedy (host floats) added."""
    out = sampler(state.params, arrays, sample_generator)
    sample_tokens = out["sample_tokens"]
    tokens = torch.stack([sample_tokens, out["greedy_tokens"]]).cpu().numpy()
    rows = (slice(None) if mesh is None
            else mesh.rows(len(batch.example_idx)))
    example_idx = batch.example_idx[rows]
    image_ids = [ds.get(int(i)).image_id for i in example_idx]
    references = {ds.get(int(i)).image_id: ds.get(int(i)).captions
                  for i in example_idx}
    r_s = rewarder.rewards(ds.vocab, tokens[0], image_ids, references)
    r_g = rewarder.rewards(ds.vocab, tokens[1], image_ids, references)
    advantage = torch.from_numpy(
        (r_s - r_g) * np.asarray(batch.valid[rows], np.float32)).to(
            sample_tokens.device)
    metrics = dict(step_fn(state, arrays, sample_tokens, advantage,
                           step_generator))
    metrics["reward_sample"], metrics["reward_greedy"] = _reward_means(
        r_s, r_g, mesh)
    return metrics


def scst_train_batch_resident(state, dd, idx, ds, sampler, step_fn,
                              rewarder, sample_generator,
                              step_generator=None, mesh=None) -> dict:
    """One SCST iteration over a `DeviceDataset` `dd`: `idx` is the batch's
    [B] pair-index array (host numpy), `sampler` a
    `make_resident_scst_sampler` and `step_fn` a `make_scst_step(...,
    resident=True)`. The per-step uploads are the index vector and the [B]
    advantage; the sampled tokens visit the host for the CIDEr-D reward.
    The two generators split as in `scst_train_batch`. With `mesh`, `dd`
    is a `ShardedDeviceDataset` and each rank scores its own chunk of
    `idx`. Updates `state` in place; returns the step's metrics with
    reward_sample and reward_greedy added."""
    idx_dev = dd.upload_index(idx)
    out = sampler(state.params, dd.data, idx_dev, sample_generator)
    sample_tokens = out["sample_tokens"]
    tokens = torch.stack([sample_tokens, out["greedy_tokens"]]).cpu().numpy()
    ex_ids = (dd.example_ids(idx) if mesh is None
              else dd.example_ids(idx, local=True))
    image_ids = [ds.get(e).image_id for e in ex_ids]
    references = {ds.get(e).image_id: ds.get(e).captions for e in ex_ids}
    r_s = rewarder.rewards(ds.vocab, tokens[0], image_ids, references)
    r_g = rewarder.rewards(ds.vocab, tokens[1], image_ids, references)
    advantage = torch.from_numpy(r_s - r_g).to(sample_tokens.device)
    metrics = dict(step_fn(state, dd.data, idx_dev, sample_tokens, advantage,
                           step_generator))
    metrics["reward_sample"], metrics["reward_greedy"] = _reward_means(
        r_s, r_g, mesh)
    return metrics
