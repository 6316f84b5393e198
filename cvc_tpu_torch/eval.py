"""Evaluate a checkpoint of the port: caption metrics and grounding F1 (the
twin of the repo root's `eval.py`, with the same flags):

    python -m cvc_tpu_torch.eval --start_from save/exp1 --split test \
        --beam_size 5 --language_eval 1 --grounding_eval 1
    python -m cvc_tpu_torch.eval --start_from save/exp1 --gt_sentence_mode 1
    python -m cvc_tpu_torch.eval --start_from save/exp1 \
        --grounding_source localizer --cycle_probes 1

The model's shapes come from the checkpoint's `config.json`; the eval
flags and the batch size from the command line. Prints the results as
JSON. Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
`--import_torch` takes a reference `.pth` or an `.npz`.
"""

import json
import os

import torch

from cvc_tpu_torch.config import config_from_args
from cvc_tpu_torch.data.datasets import load_dataset
from cvc_tpu_torch.evaluation.evaluator import evaluate_split
from cvc_tpu_torch.models import core
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.training.checkpoint import CheckpointManager, load_config
from cvc_tpu_torch.training.loop import _finalize_model_config, import_params
from cvc_tpu_torch.training.optimizer import make_optimizer
from cvc_tpu_torch.training.train_state import TrainState


def main(argv=None, device="cuda"):
    device = resolve_device(device)
    cfg = config_from_args(argv)
    if not (cfg.train.start_from or cfg.train.import_torch):
        raise SystemExit("--start_from <checkpoint dir> or "
                         "--import_torch <.pth/.npz> is required")
    # the training-time config gives the model's shapes; CLI eval flags win
    ckpt_dir = cfg.train.start_from
    if ckpt_dir and os.path.exists(os.path.join(ckpt_dir, "config.json")):
        saved = load_config(ckpt_dir)
        saved.eval = cfg.eval
        saved.data.batch_size = cfg.data.batch_size
        saved.train.import_torch = cfg.train.import_torch
        cfg = saved

    ds = load_dataset(cfg.data, cfg.model, cfg.eval.split)
    _finalize_model_config(cfg, ds)

    if cfg.train.import_torch and not ckpt_dir:
        eval_params = import_params(cfg.train.import_torch, cfg.model,
                                    device)
    else:
        params = core.init_params(torch.Generator().manual_seed(0),
                                  cfg.model, device)
        state = TrainState.create(params, make_optimizer(cfg.train, 1))
        mgr = CheckpointManager(ckpt_dir)
        step = mgr.best_step() or mgr.latest_step()
        state, infos = mgr.restore(state, step=step)
        print(f"evaluating checkpoint step {step} (best_cider="
              f"{infos.get('best_cider')}) on split={cfg.eval.split}",
              flush=True)
        eval_params = state.params

    out_path = os.path.join(cfg.eval.out_dir,
                            f"{cfg.id}_{cfg.eval.split}_preds.json")
    results = evaluate_split(eval_params, cfg.model, cfg.eval, ds,
                             cfg.data.batch_size, out_path=out_path,
                             device=device)
    if cfg.eval.cycle_probes:
        from cvc_tpu_torch.evaluation.probes import cycle_probe_metrics
        results.update(cycle_probe_metrics(eval_params, cfg.model, ds,
                                           cfg.data.batch_size,
                                           device=device))
    print(json.dumps(results, indent=2, default=float))
    return results


if __name__ == "__main__":
    main()
