"""Checkpoint and resume (the port of `cvc_tpu/training/checkpoint.py`, with
`torch.save` in place of orbax).

A directory holds `config.json` (`save_config`) and one subdirectory a
saved step:

    <dir>/<step>/state.pt      parameter tree (lists included), the torch
                               optimizer's state_dict, the step
    <dir>/<step>/infos.json    `infos` (epoch, best CIDEr, ...)
    <dir>/<step>/metrics.json  the numeric validation metrics of the save

A step is written under a temporary name and renamed into place with
`os.replace`, so a crash never leaves half a checkpoint. Saves are
asynchronous, as the JAX package's are: `save` copies the state to the
host on the caller's thread and one background thread writes it; `wait`
joins that thread.

Retention keeps the steps the JAX package's orbax manager keeps
(`max_to_keep`, `best_fn` on CIDEr, `best_mode="max"`): every save carries
a metrics dict (empty where none were given), which ranks by its CIDEr or
-1; after each save the checkpoints are sorted by that rank, stably in
step order, and the last `max_to_keep` are kept, so the step just saved
is deleted when it ranks below all the others. `best_step` is the last of
that order, `latest_step` the highest step kept; a save at a step not
above `latest_step` is skipped.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import torch

from cvc_tpu_torch.training.train_state import TrainState, tree_items

BEST_METRIC = "CIDEr"
_STATE = "state.pt"
_INFOS = "infos.json"
_METRICS = "metrics.json"


def _rank(metrics: dict) -> float:
    return metrics.get(BEST_METRIC, -1.0)


def _host_copy(obj):
    """The same nested structure with every tensor detached and copied to
    host memory (the device's values at this point of its queue)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _host_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_host_copy(v) for v in obj)
    return obj


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        directory = os.path.abspath(directory)
        os.makedirs(directory, exist_ok=True)
        self._dir = directory
        self._max_to_keep = max_to_keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._checkpoints = self._scan()

    def _scan(self) -> list:
        """(step, metrics) of the steps on disk, in step order."""
        out = []
        for name in sorted((n for n in os.listdir(self._dir) if n.isdigit()),
                           key=int):
            path = os.path.join(self._dir, name, _METRICS)
            if os.path.exists(path):
                with open(path) as f:
                    out.append((int(name), json.load(f)))
        return out

    def save(self, step: int, state: TrainState, infos: dict,
             metrics: Optional[dict] = None) -> None:
        """metrics: val metrics dict (CIDEr drives best-retention; entries
        that are not finite numbers are dropped)."""
        latest = self.latest_step()
        if latest is not None and step <= latest:
            return
        clean_metrics = {k: float(v) for k, v in (metrics or {}).items()
                         if isinstance(v, (int, float)) and v == v}
        payload = {"params": _host_copy(state.params),
                   "opt": _host_copy(state.opt.state_dict()),
                   "step": int(state.step)}
        infos = json.loads(json.dumps(infos))
        self.wait()
        self._checkpoints.append((step, clean_metrics))
        self._thread = threading.Thread(
            target=self._write, args=(step, payload, infos, clean_metrics,
                                      self._to_remove()),
            name=f"checkpoint-{step}", daemon=True)
        self._thread.start()

    def _to_remove(self) -> list:
        """Drops from the in-memory list, and returns, the steps that
        retention deletes once the newest save is written."""
        if len(self._checkpoints) <= self._max_to_keep:
            return []
        ranked = sorted(self._checkpoints, key=lambda sm: _rank(sm[1]))
        keep = {s for s, _ in ranked[-self._max_to_keep:]}
        gone = [s for s, _ in self._checkpoints if s not in keep]
        self._checkpoints = [sm for sm in self._checkpoints if sm[0] in keep]
        return gone

    def _write(self, step, payload, infos, metrics, remove) -> None:
        final = os.path.join(self._dir, str(step))
        tmp = os.path.join(self._dir, f".{step}.tmp")
        try:
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            torch.save(payload, os.path.join(tmp, _STATE))
            with open(os.path.join(tmp, _INFOS), "w") as f:
                json.dump(infos, f)
            with open(os.path.join(tmp, _METRICS), "w") as f:
                json.dump(metrics, f)
            shutil.rmtree(final, ignore_errors=True)
            os.replace(tmp, final)
            for s in remove:
                shutil.rmtree(os.path.join(self._dir, str(s)),
                              ignore_errors=True)
        except Exception as e:         # raised to the caller by wait()
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e

    def wait(self) -> None:
        """Blocks until the save in flight is on disk. A failed save is
        raised here, and the steps on disk (the older ones, untouched) are
        what the manager then holds."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            self._checkpoints = self._scan()
            raise err

    def latest_step(self) -> Optional[int]:
        return self._checkpoints[-1][0] if self._checkpoints else None

    def best_step(self) -> Optional[int]:
        if not self._checkpoints:
            return None
        return sorted(self._checkpoints, key=lambda sm: _rank(sm[1]))[-1][0]

    def restore(self, state_like: TrainState, step: Optional[int] = None
                ) -> tuple[TrainState, dict]:
        """Load a step (default the latest) into `state_like`, a freshly
        made TrainState whose tree has the saved paths (`tree_items`
        order keys the optimizer's moments): its parameters are
        overwritten in place on their device, its optimizer's state
        loaded and its step set. Returns (state_like, infos)."""
        self.wait()
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        path = os.path.join(self._dir, str(step))
        payload = torch.load(os.path.join(path, _STATE), map_location="cpu",
                             weights_only=True)
        with open(os.path.join(path, _INFOS)) as f:
            infos = json.load(f)
        saved = dict(tree_items(payload["params"]))
        live = dict(tree_items(state_like.params))
        if list(saved) != list(live):
            raise ValueError(
                f"checkpoint {path} holds parameters "
                f"{sorted(set(saved) ^ set(live))} that the state does not "
                f"match")
        with torch.no_grad():
            for name, p in live.items():
                if p.shape != saved[name].shape:
                    raise ValueError(f"{name}: checkpoint shape "
                                     f"{tuple(saved[name].shape)}, state "
                                     f"{tuple(p.shape)}")
                p.copy_(saved[name])
        state_like.opt.load_state_dict(payload["opt"])
        state_like.step = int(payload["step"])
        return state_like, infos

    def close(self) -> None:
        self.wait()


def save_config(directory: str, cfg) -> None:
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "config.json"), "w") as f:
        f.write(cfg.to_json())


def load_config(directory: str):
    from cvc_tpu_torch.config import Config
    with open(os.path.join(directory, "config.json")) as f:
        return Config.from_json(f.read())
