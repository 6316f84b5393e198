"""Train the cyclical grounded-captioning model with the port (the twin of
the repo root's `train.py`, with the same flags):

    python -m cvc_tpu_torch.train --dataset synthetic --batch_size 32 \
        --max_epochs 10 --enable_cycle 1 --checkpoint_path save/exp1
    python -m cvc_tpu_torch.train ... --start_from save/exp1   # resume
    python -m cvc_tpu_torch.train ... --num_devices 2 [--model_axis 2]
    torchrun --nproc_per_node 2 -m cvc_tpu_torch.train ... --num_devices 2

`--num_devices N` (alias `--mGPUs`; 0, the default, takes every visible
card) trains over N ranks, one process a card: the command starts them
itself (NCCL where each rank has a card of its own, else gloo), or, under
a launcher that sets RANK / WORLD_SIZE / LOCAL_RANK (torchrun), is one
of them. Prints one JSON line, {"done": true, <the infos of
training.loop.train>}, at the end (rank 0's). Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU (ranks over gloo).
"""

import json
import sys

from cvc_tpu_torch.config import config_from_args
from cvc_tpu_torch.ops.dispatch import resolve_device
from cvc_tpu_torch.parallel import launch
from cvc_tpu_torch.training.loop import train, world_size


def _rank_main(rank, world, argv, device_type):
    """One rank of a run that `main` started."""
    import torch
    device = launch.rank_device(device_type, rank)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return train(config_from_args(argv), device=device)


def main(argv=None, device="cuda"):
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = config_from_args(argv)
    device = resolve_device(device)
    if launch.launched():
        infos = train(cfg, device=launch.init_from_env(device.type))
        import torch.distributed as dist
        if dist.get_rank() != 0:
            return infos
    else:
        n = world_size(cfg.train, device)
        if n > 1:
            infos = launch.spawn(_rank_main, n, (argv, device.type),
                                 backend=launch.backend_for(device.type,
                                                            n))[0]
        else:
            infos = train(cfg, device=device)
    print(json.dumps({"done": True, **infos}))
    return infos


if __name__ == "__main__":
    main()
