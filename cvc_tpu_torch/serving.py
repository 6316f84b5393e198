"""Serving API: batched grounded-caption inference (the port of
`cvc_tpu/serving.py`).

    cap = Captioner.from_checkpoint("save/exp1", beam_size=5)
    cap = Captioner.from_torch("model-best.pth", "config.json", "vocab.json")
    out = cap.caption([{"features": f, "boxes": b, "classes": c}, ...])
    # -> [{"caption": str, "score": float,
    #      "grounding": [{"word", "box", "weight"}, ...]}, ...]

Requests are packed into fixed-size batches of padded region slots, so
every batch has the same shapes. Entry points run on CUDA unless the
caller passes device="cpu".
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np
import torch

from cvc_tpu_torch.config import Config, EvalConfig
from cvc_tpu_torch.data.pipeline import pad_regions_into
from cvc_tpu_torch.data.vocab import Vocabulary
from cvc_tpu_torch.models import core
from cvc_tpu_torch.models.decoding import make_decoder
from cvc_tpu_torch.models.weights import params_from_numpy
from cvc_tpu_torch.ops.dispatch import resolve_device


@dataclass
class Captioner:
    params: dict
    model_cfg: object
    vocab: Vocabulary
    decoder: object
    batch_size: int
    device: torch.device
    # pinned request buffers (CUDA), used in turn, and the stream that
    # copies them to the card; see _staging
    _pinned: list = field(default_factory=list, repr=False)
    _turn: int = 0
    _copy_stream: object = field(default=None, repr=False)

    @staticmethod
    def from_checkpoint(checkpoint_dir: str, beam_size: int = 5,
                        batch_size: int = 64, length_penalty: float = 0.0,
                        vocab: Vocabulary | None = None,
                        device="cuda") -> "Captioner":
        """Serve a directory that the port's `training.loop.train` wrote:
        its `config.json`, the vocabulary (`vocab` if given, else the
        config's vocab file, else the dataset's), and its best step, else
        its latest."""
        import os

        from cvc_tpu_torch.training.checkpoint import (CheckpointManager,
                                                       load_config)
        from cvc_tpu_torch.training.optimizer import make_optimizer
        from cvc_tpu_torch.training.train_state import TrainState

        device = resolve_device(device)
        cfg = load_config(checkpoint_dir)
        if vocab is None:
            vp = cfg.data.vocab_file
            if vp and os.path.exists(vp):
                vocab = Vocabulary.load(vp)
            else:
                from cvc_tpu_torch.data.datasets import load_dataset
                vocab = load_dataset(cfg.data, cfg.model, "train").vocab
        cfg.model.vocab_size = vocab.padded_size(128)
        params = core.init_params(torch.Generator().manual_seed(0),
                                  cfg.model, device)
        state = TrainState.create(params, make_optimizer(cfg.train, 1))
        mgr = CheckpointManager(checkpoint_dir)
        step = mgr.best_step() or mgr.latest_step()
        state, _ = mgr.restore(state, step=step)
        params = core._map(state.params, lambda p: p.detach())
        return Captioner.build(params, cfg.model, vocab, beam_size,
                               batch_size, length_penalty, device)

    @staticmethod
    def from_torch(ckpt_path: str, config_json: str, vocab_file: str,
                   beam_size: int = 5, batch_size: int = 64,
                   length_penalty: float = 0.0,
                   device="cuda") -> "Captioner":
        """Serve a reference-lineage torch checkpoint (.pth/.pt, mapped by
        `models/torch_import.py`) or an .npz parameter file (the flat
        `a/b/c` layout that `save_params_npz` writes, from either package)
        with a `config.json` of either package and a vocabulary file."""
        from cvc_tpu_torch.models.torch_import import import_params
        device = resolve_device(device)
        with open(config_json) as f:
            cfg = Config.from_json(f.read())
        vocab = Vocabulary.load(vocab_file)
        cfg.model.vocab_size = vocab.padded_size(128)
        params, _ = import_params(ckpt_path, cfg.model, device=device)
        return Captioner.build(params, cfg.model, vocab, beam_size,
                               batch_size, length_penalty, device)

    @staticmethod
    def build(params, model_cfg, vocab, beam_size: int = 5,
              batch_size: int = 64, length_penalty: float = 0.0,
              device="cuda") -> "Captioner":
        """params: a nested dict of tensors or numpy arrays in the JAX
        package's layout. The weights are moved to `device` and cast once
        to the type the decoder runs in (`core.decoder_dtype`)."""
        device = resolve_device(device)
        e_cfg = EvalConfig(beam_size=beam_size,
                           sample_method="beam" if beam_size > 1 else "greedy",
                           max_length=model_cfg.seq_length,
                           length_penalty=length_penalty)
        decoder = make_decoder(model_cfg, e_cfg, device)
        params = core.cast_params(params_from_numpy(params, device),
                                  core.decoder_dtype(model_cfg))
        return Captioner(params=params, model_cfg=model_cfg, vocab=vocab,
                         decoder=decoder, batch_size=batch_size,
                         device=device)

    def caption(self, requests: list[dict],
                pipeline_depth: int = 1) -> list[dict]:
        """requests: [{'features': [N,D] or [F,N,D], 'boxes': [...,4],
        'classes': [...], 'global_feat'?: [Dg]}]. Any request count:
        internally padded to the fixed batch size.

        `pipeline_depth > 1` keeps that many batches in flight: CUDA
        launches are asynchronous, so batch i's device-to-host read waits
        until batch i + depth - 1 has been submitted, and the host packs
        the next batch while the card decodes. Packing waits for no decode:
        a batch's copy to the card runs on a stream of its own, which the
        decode waits for (see _pack). Results are identical at any depth,
        in request order. One call at a time per Captioner: the request
        buffers are reused."""
        out: list[dict] = []
        inflight: deque = deque()
        depth = max(1, int(pipeline_depth))
        for s in range(0, len(requests), self.batch_size):
            chunk = requests[s:s + self.batch_size]
            arrays, boxes = self._pack(chunk)
            res = self.decoder(self.params, arrays)   # queued, not waited on
            inflight.append((chunk, boxes, res))
            if len(inflight) >= depth:
                out.extend(self._postprocess(*inflight.popleft()))
        while inflight:
            out.extend(self._postprocess(*inflight.popleft()))
        return out

    def _postprocess(self, chunk: list[dict], boxes: np.ndarray,
                     res: dict) -> list[dict]:
        """One in-flight result to the response schema (the host waits for
        the card here). boxes: [n, S, 4], the chunk's padded boxes."""
        n = len(chunk)
        tokens = res["tokens"][:n].cpu().numpy()
        alphas = res["alphas"][:n].cpu().numpy()                  # [n, L, S]
        scores = (res["scores"][:n].cpu().numpy() if "scores" in res
                  else np.zeros(n))
        sents = self.vocab.decode_sequence(tokens)
        slots = alphas.argmax(axis=-1)                            # [n, L]
        weights = np.take_along_axis(alphas, slots[..., None], -1)[..., 0]
        word_boxes = boxes[np.arange(n)[:, None], slots]          # [n, L, 4]
        return [{"caption": sents[i],
                 "score": float(scores[i]),
                 "grounding": [{"word": w,
                                "box": word_boxes[i, t].tolist(),
                                "weight": float(weights[i, t])}
                               for t, w in enumerate(sents[i].split())]}
                for i in range(n)]

    def _pack(self, chunk: list[dict]):
        """Pad one chunk of requests to the batch's static shapes; returns
        (the model's input tensors on the device, the chunk's boxes
        [n, S, 4] in numpy)."""
        mc = self.model_cfg
        host, turn = self._staging()
        feats, geom, cls, mask = (host[k].numpy() for k in (
            "feats", "box_geom", "region_cls", "region_mask"))
        gfeat = host["global_feat"].numpy() if "global_feat" in host else None
        for i in range(self.batch_size):
            if i >= len(chunk):                 # padding rows of the batch
                feats[i], geom[i], cls[i], mask[i] = 0.0, 0.0, 0, 0.0
                if gfeat is not None:
                    gfeat[i] = 0.0
                continue
            r = chunk[i]
            f = np.asarray(r["features"], np.float32)
            b = np.asarray(r["boxes"], np.float32)
            c = np.asarray(r.get("classes",
                                 np.zeros(b.shape[:-1], np.int32)), np.int32)
            pad_regions_into(feats[i], geom[i], cls[i], mask[i], f, b, c,
                             mc.num_frames, mc.num_regions, mc.feat_dim)
            if gfeat is not None:
                gfeat[i] = 0.0
                if "global_feat" in r:
                    g = np.asarray(r["global_feat"], np.float32)
                    gfeat[i, :g.shape[0]] = g[:mc.global_feat_dim]
        boxes = geom[:len(chunk), :, :4].copy()
        if turn is None:                        # the CPU: no copy
            return {k: t.to(self.device) for k, t in host.items()}, boxes
        # the copies run on the copy stream, in the order of the batches,
        # behind no decode; the decode waits for them, and the set is free
        # again once they have run
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._copy_stream):
            arrays = {k: t.to(self.device, non_blocking=True)
                      for k, t in host.items()}
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        compute.wait_event(done)
        for t in arrays.values():       # allocated on the copy stream,
            t.record_stream(compute)    # freed after the decode's use
        self._pinned[turn] = (host, done)
        return arrays, boxes

    def _staging(self):
        """Host tensors for the next batch, and the index of their pinned
        set. On CUDA two sets of pinned buffers are used in turn; a set is
        refilled only after its own copy to the card has run, which waits
        only for the copies before it on the copy stream, never for a
        decode. On the CPU the tensors are fresh (the device tensors share
        their memory)."""
        mc = self.model_cfg
        B, S = self.batch_size, mc.total_regions
        shapes = {"feats": ((B, S, mc.feat_dim), torch.float32),
                  "box_geom": ((B, S, 5), torch.float32),
                  "region_cls": ((B, S), torch.int32),
                  "region_mask": ((B, S), torch.float32)}
        if mc.global_feat_dim:
            shapes["global_feat"] = ((B, mc.global_feat_dim), torch.float32)
        if self.device.type != "cuda":
            return {k: torch.zeros(shape, dtype=dt)
                    for k, (shape, dt) in shapes.items()}, None
        if not self._pinned:
            self._pinned = [({k: torch.empty(shape, dtype=dt, pin_memory=True)
                              for k, (shape, dt) in shapes.items()}, None)
                            for _ in range(2)]
            self._copy_stream = torch.cuda.Stream(self.device)
        turn = self._turn
        self._turn = 1 - turn
        host, done = self._pinned[turn]
        if done is not None:
            done.synchronize()
        return host, turn
