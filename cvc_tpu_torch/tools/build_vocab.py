"""Offline preprocessing: build the count-thresholded vocabulary (the
twin of `tools/build_vocab.py`, with the same flags):

    python -m cvc_tpu_torch.tools.build_vocab --annotation_file ann.json \
        --out vocab.json --min_count 5

Host work only (`cvc_tpu_torch.data.vocab`); like every entry point of the
port it runs for CUDA, and `main(argv, device="cpu")` on the CPU.
"""

import argparse
import json

from cvc_tpu_torch.data.vocab import Vocabulary
from cvc_tpu_torch.ops.dispatch import resolve_device


def main(argv=None, device="cuda"):
    p = argparse.ArgumentParser()
    p.add_argument("--annotation_file", required=True,
                   help="canonical annotation JSON (see datasets.py)")
    p.add_argument("--out", required=True)
    p.add_argument("--min_count", type=int, default=5)
    args = p.parse_args(argv)
    resolve_device(device)

    with open(args.annotation_file) as f:
        ann = json.load(f)
    captions = [c for img in ann["images"] for c in img["captions"]]
    vocab = Vocabulary.build(captions, min_count=args.min_count)
    vocab.save(args.out)
    print(f"{len(captions)} captions -> vocab of {len(vocab)} words "
          f"(padded size {vocab.padded_size()}) -> {args.out}")
    return vocab


if __name__ == "__main__":
    main()
