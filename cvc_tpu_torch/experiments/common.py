"""What the experiment twins share: the paths they write, the smoke size,
running the port's CLIs, and reading their logs.

The JAX scripts in `experiments/` repeat these pieces each; the twins in
this package take them from here.

- Paths: each twin writes its JSON under `experiments/h100/` (`out_path`;
  `write_json` refuses `experiments/*.json`, the JAX package's records)
  and its checkpoints and logs under a work directory, by default
  `experiments/h100/runs/`, which git ignores (the JAX scripts use
  `/tmp/<name>` and `experiments/ckpt_*`).
- The port's CLIs: `run_cli("train", flags, log)` runs `python -m
  cvc_tpu_torch.train <flags>` (or `.eval`) with its output in `log`, as
  the JAX scripts run `train.py` / `eval.py`. With `in_process` it calls
  the CLI's `main(flags, device)` in this process instead, its output
  (that of any ranks it starts too) sent to the log: one CUDA context,
  and the kernels' launch counters see the run.
- Logs: `parse_val` / `parse_log` read the `[step N] val/<key>=<value>`
  and `train/loss=` lines, which the port prints in the JAX package's
  format (`utils/logging.py`).
- `--smoke`: `smoke_flags` cuts a CLI flag list to a tiny world
  (`SMOKE_IMAGES`, `SMOKE_VAL_IMAGES`), batch (`SMOKE_BATCH`) and widths
  (`SMOKE_WIDTHS`, which the kernels take) and scales every epoch count
  by 1/16 (`smoke_epochs`: 48 epochs become 3, a cycle after 8 and GT
  queries until 24 become 1 and 2, so every stage still runs) and runs
  at most `SMOKE_RANKS` ranks; the region, class and vocabulary counts
  stay.
- `--device`: the twins run on CUDA unless given `--device cpu`; nothing
  falls back to the CPU.
- `record_missing`: the key paths of a JAX record that a twin's JSON
  lacks, runs keyed by name and seed (`<arm>_s<seed>`) and seeds
  collapsed.
"""

from __future__ import annotations

import contextlib
import os
import re
import subprocess
import sys
import traceback

from cvc_tpu_torch.tools.benchlib import OUT_DIR, REPO_ROOT, key_paths
from cvc_tpu_torch.tools.benchlib import write_json  # noqa: F401 (re-export)

RUN_DIR = os.path.join(OUT_DIR, "runs")      # checkpoints and logs

SMOKE_IMAGES = 64
SMOKE_VAL_IMAGES = 16
SMOKE_BATCH = 16
SMOKE_WIDTHS = {"rnn_size": 64, "input_encoding_size": 32,
                "att_hid_size": 32, "feat_dim": 64}
SMOKE_RANKS = 2                              # --mGPUs of a smoke run

# the CLI flags that count epochs, scaled by smoke_epochs
EPOCH_FLAGS = ("--max_epochs", "--cycle_after", "--cycle_gt_until",
               "--cycle_weight_anneal_after", "--learning_rate_decay_start",
               "--learning_rate_decay_every", "--val_every_epoch",
               "--save_checkpoint_every", "--self_critical_after")
SMOKE_VALUES = {"--synthetic_num_images": SMOKE_IMAGES,
                "--synthetic_num_val_images": SMOKE_VAL_IMAGES,
                "--batch_size": SMOKE_BATCH,
                "--losses_log_every": 1,
                "--global_feat_dim": SMOKE_WIDTHS["feat_dim"],
                **{"--" + k: v for k, v in SMOKE_WIDTHS.items()}}

CLI_MODULES = {"train": "cvc_tpu_torch.train", "eval": "cvc_tpu_torch.eval"}


def out_path(name: str) -> str:
    """A twin's default JSON: experiments/h100/<name>."""
    return os.path.join(OUT_DIR, name)


def smoke_epochs(e: int) -> int:
    """An epoch count at the smoke size: e / 16, rounded half up, at
    least 1."""
    return max(1, int(e / 16 + 0.5))


def smoke_flags(flags: list) -> list:
    """A CLI flag list at the smoke size (see the module doc)."""
    out = list(flags)
    for i in range(len(out) - 1):
        if out[i] in SMOKE_VALUES:
            out[i + 1] = str(SMOKE_VALUES[out[i]])
        elif out[i] in EPOCH_FLAGS and int(out[i + 1]) > 0:
            out[i + 1] = str(smoke_epochs(int(out[i + 1])))
        elif out[i] == "--mGPUs":
            out[i + 1] = str(min(int(out[i + 1]), SMOKE_RANKS))
    return out


def add_args(ap, cli: bool = True) -> None:
    """The flags every twin adds to its JAX script's: --smoke, --device,
    --workdir and, for a twin that runs the CLIs, --in_process."""
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny world, batch and widths, epochs / 16 "
                         "(a check of the twin, not a result)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--workdir", default=RUN_DIR,
                    help="checkpoints and logs (default experiments/h100/"
                         "runs, ignored by git)")
    if cli:
        ap.add_argument("--in_process", action="store_true",
                        help="run the CLIs in this process, not one "
                             "subprocess each")


def cli_command(cli: str, argv: list, device: str) -> list:
    """The command of one CLI run: `python -m cvc_tpu_torch.<cli>` on
    CUDA, its `main(argv, device=...)` elsewhere."""
    module = CLI_MODULES[cli]
    if device == "cuda":
        return [sys.executable, "-m", module, *argv]
    return [sys.executable, "-c", f"import sys; from {module} import main; "
            f"main(sys.argv[1:], device={device!r})", *argv]


@contextlib.contextmanager
def _output_to(log_path: str):
    """This process's output, and that of the processes it starts, to
    `log_path` (appended)."""
    sys.stdout.flush()
    sys.stderr.flush()
    saved = (os.dup(1), os.dup(2))
    fd = os.open(log_path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        with open(log_path, "a", buffering=1) as f, \
                contextlib.redirect_stdout(f), contextlib.redirect_stderr(f):
            os.dup2(fd, 1)
            os.dup2(fd, 2)
            yield
    finally:
        sys.stdout.flush()
        sys.stderr.flush()
        os.dup2(saved[0], 1)
        os.dup2(saved[1], 2)
        for x in (fd, *saved):
            os.close(x)


def run_cli(cli: str, argv: list, log_path: str, device: str = "cuda",
            in_process: bool = False) -> bool:
    """Runs the port's `cli` ("train" or "eval") with `argv`, its output in
    `log_path` (written anew); True when it succeeded. On failure prints
    the log's last lines, as the JAX scripts do."""
    os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
    print(f"-> {cli} {' '.join(argv[:4])} ... log: {log_path}", flush=True)
    open(log_path, "w").close()
    if in_process:
        import importlib
        main = importlib.import_module(CLI_MODULES[cli]).main
        ok = True
        with _output_to(log_path):
            try:
                main(list(argv), device=device)
            except (Exception, SystemExit):     # the CLI's failure, logged
                traceback.print_exc()
                ok = False
    else:
        with open(log_path, "w") as f:
            ok = subprocess.run(cli_command(cli, argv, device), stdout=f,
                                stderr=subprocess.STDOUT,
                                cwd=REPO_ROOT).returncode == 0
    if not ok:
        print("\n".join(open(log_path, errors="replace")
                        .read().splitlines()[-12:]), flush=True)
    return ok


def parse_val(path: str, trigger: str = "val/F1_loc",
              value: str = r"-?[0-9.]+", key: str = r"[\w.]+",
              with_step: bool = True) -> list:
    """The validation trajectory of a CLI log: one dict of the `val/`
    metrics per line holding `trigger`, with its `[step N]` (-1 where a
    line has none) first. The JAX scripts' parsers differ in the trigger
    and in the value and key patterns; each twin passes its script's."""
    traj = []
    pattern = re.compile(rf"val/({key})=({value})")
    for line in open(path, errors="replace"):
        if trigger in line:
            m = dict(pattern.findall(line))
            row = {k: float(v) for k, v in m.items()}
            if with_step:
                step = re.match(r"\[step (\d+)\]", line)
                row = {"step": int(step.group(1)) if step else -1, **row}
            traj.append(row)
    return traj


def parse_log(path: str, with_step: bool = True) -> tuple:
    """(the val trajectory as `parse_val` with its unsigned values, the
    `train/loss=` values in order) of a CLI log."""
    losses = []
    for line in open(path, errors="replace"):
        m = re.search(r"train/loss=([0-9.]+)", line)
        if m:
            losses.append(float(m.group(1)))
    return parse_val(path, value=r"[0-9.]+", with_step=with_step), losses


_RUN = re.compile(r"_s\d+$")


def record_paths(obj) -> set:
    """`key_paths` of a result JSON with each run keyed by name and seed
    (`<arm>_s<seed>`) standing as `*`."""
    return {"/".join("*" if _RUN.search(part) else part
                     for part in p.split("/")) for p in key_paths(obj)}


def record_missing(got, record, renamed: dict | None = None) -> list:
    """The key paths of the JAX record `record` (a path under the repo
    root, or the record itself as a dict) that `got` lacks; `renamed` maps
    a key the record holds to the name the JAX script writes now."""
    import json
    if isinstance(record, str):
        with open(os.path.join(REPO_ROOT, record)) as f:
            record = json.load(f)
    want = record_paths(record)
    renamed = renamed or {}
    want = {"/".join(renamed.get(k, k) for k in p.split("/")) for p in want}
    return sorted(want - record_paths(got))


# the eval CLI's teacher-forced attention probe (GT-sentence mode, greedy)
GT_EVAL_FLAGS = ["--split", "val", "--gt_sentence_mode", "1",
                 "--language_eval", "0", "--grounding_eval", "0",
                 "--sample_method", "greedy", "--beam_size", "1"]


class Runner:
    """The CLI runs of one twin invocation: its device, --smoke (each flag
    list through `smoke_flags`), --in_process and work directory, where
    run `<name>` keeps its checkpoint `<workdir>/<name>` and log
    `<workdir>/<name>.log`."""

    def __init__(self, args):
        from cvc_tpu_torch.ops.dispatch import resolve_device
        resolve_device(args.device)      # raises without a GPU unless "cpu"
        self.device = args.device
        self.smoke = args.smoke
        self.in_process = args.in_process
        self.workdir = os.path.abspath(args.workdir)
        os.makedirs(self.workdir, exist_ok=True)

    def path(self, name: str) -> str:
        return os.path.join(self.workdir, name)

    def cli(self, cli: str, flags: list, log_path: str) -> bool:
        if self.smoke:
            flags = smoke_flags(flags)
        if cli == "eval":          # predictions into the work directory
            flags = [*flags, "--out_dir", self.path("eval_out")]
        return run_cli(cli, flags, log_path, self.device, self.in_process)

    def train(self, name: str, flags: list, log_path: str | None = None
              ) -> bool:
        """`python -m cvc_tpu_torch.train <flags> --checkpoint_path
        <workdir>/<name> --id <name>`."""
        return self.cli("train", [*flags, "--checkpoint_path",
                                  self.path(name), "--id", name],
                        log_path or self.path(name + ".log"))

    def tf_attn_acc(self, ckpt: str, log_path: str) -> tuple:
        """(teacher-forced attention accuracy, {ckpt, the step the eval
        CLI restored}) of a checkpoint, read from the eval CLI's output;
        (None, {ckpt, None}) when the eval failed."""
        if self.cli("eval", ["--start_from", ckpt, *GT_EVAL_FLAGS],
                    log_path):
            text = open(log_path, errors="replace").read()
            m = re.search(r'"attn_accuracy":\s*([0-9.]+)', text)
            s = re.search(r"evaluating checkpoint step (\d+)", text)
            return (float(m.group(1)) if m else None,
                    {"ckpt": ckpt, "step": int(s.group(1)) if s else None})
        return None, {"ckpt": ckpt, "step": None}


def load_json(path: str, default: dict) -> dict:
    """A twin's earlier results (runs kept side by side), or `default`."""
    import json
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return default
