"""Train the cyclical grounded-captioning model with the port (the twin of
the repo root's `train.py`, with the same flags):

    python -m cvc_tpu_torch.train --dataset synthetic --batch_size 32 \
        --max_epochs 10 --enable_cycle 1 --checkpoint_path save/exp1
    python -m cvc_tpu_torch.train ... --start_from save/exp1   # resume

Prints one JSON line, {"done": true, <the infos of training.loop.train>},
at the end. Runs on CUDA; `main(argv, device="cpu")` runs on the CPU.
"""

import json

from cvc_tpu_torch.config import config_from_args
from cvc_tpu_torch.training.loop import train


def main(argv=None, device="cuda"):
    cfg = config_from_args(argv)
    infos = train(cfg, device=device)
    print(json.dumps({"done": True, **infos}))
    return infos


if __name__ == "__main__":
    main()
