"""Convert a reference-lineage PyTorch checkpoint to the port's parameter
file (the twin of `tools/import_torch_checkpoint.py`, with the same flags):

    python -m cvc_tpu_torch.tools.import_torch_checkpoint \
        --ckpt model-best.pth --config_json save/config.json \
        --out imported_params.npz [--rename renames.json] \
        [--att_input_order hge]

Writes the flat `a/b/c` `.npz` that `--import_torch` and
`Captioner.from_torch` take (either package reads it) and, beside it,
`<out>.report.json`, the mapping report. The mapping rules are in
`cvc_tpu_torch/models/torch_import.py`; unknown checkpoint names can be
renamed first with --rename (a JSON {checkpoint key: canonical key}), and
every unmapped key is listed in the report. Runs on CUDA;
`main(argv, device="cpu")` runs on the CPU.
"""

import argparse
import json

from cvc_tpu_torch.config import Config
from cvc_tpu_torch.models.torch_import import (convert_state_dict,
                                               load_torch_state_dict)
from cvc_tpu_torch.models.weights import save_params_npz
from cvc_tpu_torch.ops.dispatch import resolve_device


def main(argv=None, device="cuda"):
    ap = argparse.ArgumentParser(
        description="Import a reference torch checkpoint into cvc_tpu_torch")
    ap.add_argument("--ckpt", required=True, help=".pth/.pt state_dict")
    ap.add_argument("--config_json", required=True,
                    help="Config JSON (e.g. save/config.json or a configs/ "
                         "preset) describing the target model")
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--rename", default=None,
                    help="JSON file {ckpt_key: canonical_key}")
    ap.add_argument("--att_input_order", default="hge",
                    help="checkpoint att-LSTM input concat order over "
                         "h=h_lang g=v_global e=emb (reference: hge)")
    args = ap.parse_args(argv)
    device = resolve_device(device)

    with open(args.config_json) as f:
        cfg = Config.from_json(f.read())
    rename = None
    if args.rename:
        with open(args.rename) as f:
            rename = json.load(f)

    sd = load_torch_state_dict(args.ckpt)
    params, report = convert_state_dict(sd, cfg.model, rename=rename,
                                        att_input_order=args.att_input_order,
                                        device=device)
    save_params_npz(params, args.out)
    report_path = args.out + ".report.json"
    with open(report_path, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {args.out} ({len(report['mapped'])} ckpt keys mapped, "
          f"vocab {report['ckpt_vocab']} -> {report['padded_vocab']})")
    if report["zero_filled"]:
        print("zero-filled (no torch counterpart): "
              + ", ".join(report["zero_filled"]))
    if report["unmapped"]:
        print("WARNING unmapped checkpoint keys (use --rename): "
              + ", ".join(report["unmapped"]))
    print(f"report: {report_path}")
    return report


if __name__ == "__main__":
    main()
