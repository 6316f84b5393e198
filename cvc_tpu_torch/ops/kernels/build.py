"""Build and bind the CUDA kernels of `cvc_tpu_torch/csrc/`.

The sources are compiled for Hopper (`sm_90a`) with `nvcc` at first use,
one `nvcc -c` per source, all started together, then linked into one
shared library with a plain C interface that `ctypes` loads. The library
lands in `cvc_tpu_torch/_build/<hash>/`, keyed on a hash of the sources
and the flags, so an edited source rebuilds and an unchanged one loads at
once. Nothing here runs when the module is imported: the CPU never needs
`nvcc`, and the kernels' wrappers call `launch` only for CUDA tensors.

Every C entry point takes its pointers and the stream as `void*`, its
sizes as `int`, and returns the `cudaError_t` of its launch; `launch`
raises when that is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
LIB_NAME = "libcvc_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point -> argument types (pointers and the stream as void*)
SIGNATURES = {
    "cvc_lstm_gates_fwd": [_P, _P, _P, _P, _I, _I, _I, _P],
    "cvc_lstm_gates_bwd": [_P] * 6 + [_I] * 3 + [_P],
    "cvc_additive_attention_fwd": [_P] * 8 + [_I] * 5 + [_P],
    "cvc_additive_attention_bwd": [_P] * 14 + [_I] * 5 + [_P],
    "cvc_masked_xent_fwd": [_P] * 4 + [_I] * 3 + [_P],
    "cvc_masked_xent_bwd": [_P] * 5 + [_I] * 3 + [_P],
    "cvc_beam_decoder_core": [_P] * 13 + [_I] * 6 + [_P],
    "cvc_topk_lse": [_P] * 5 + [_I] * 6 + [_P],
}

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the kernels that split an image over a cluster (csrc/row_ring.cuh):
# blocks an image, and clock stamps a block writes when asked for them
CLUSTER_BLOCKS = 2
STAMP_SLOTS = 8

_lock = threading.Lock()
_lib = None
build_seconds: float | None = None   # wall time of the last build, if any


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    global build_seconds
    t0 = time.perf_counter()
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_DIR))
    try:
        procs = []
        for src in _sources():
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(work / (src.stem + ".o"))]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        errors = []
        for src, p in procs:
            log = p.communicate()[0]
            if p.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
        if errors:
            raise RuntimeError("nvcc failed\n" + "\n".join(errors))
        lib = work / LIB_NAME
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *sorted(map(str, work.glob("*.o"))),
             "-o", str(lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed\n" + link.stdout)
        out.parent.mkdir(parents=True, exist_ok=True)
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if its sources changed."""
    global _lib
    with _lock:
        if _lib is None:
            out = BUILD_DIR / _digest() / LIB_NAME
            if not out.exists():
                _compile(out)
            lib = ctypes.CDLL(str(out))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.cvc_error_string.argtypes = [ctypes.c_int]
            lib.cvc_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def launch(name: str, *args) -> None:
    """Call C entry point `name` with tensors passed as their data
    pointers (None as a null pointer), then the current stream of the
    first tensor's device. Raises RuntimeError when the launch reports a
    CUDA error."""
    lib = library()
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    stream = torch.cuda.current_stream(device).cuda_stream
    c_args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = getattr(lib, name)(*c_args, stream)
    if rc != 0:
        msg = lib.cvc_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def check_cuda(name: str, tensors: dict, dtype=None, device=None) -> torch.device:
    """Raise ValueError unless every tensor lies on one CUDA device, is
    contiguous and (when given) has `dtype`. Returns the device."""
    for arg, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {arg} is on {t.device}, expected CUDA")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{name}: {arg} is on {t.device}, others on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"{name}: {arg} is {t.dtype}, expected {dtype}")
    return device


def vector_elems(elem_size: int) -> int:
    """Elements of `elem_size` bytes in one 16-byte vector, the unit every
    kernel moves rows in."""
    return 16 // elem_size


def width_error(widths: dict, limits: dict | None = None) -> str | None:
    """The first width that a kernel does not take, as the rule it breaks,
    or None: the kernels move rows in 16-byte vectors and take no other
    layout. `widths` maps a width's name to (value, multiple in elements),
    `limits` to (value, largest value, that limit in 16-byte vectors)."""
    for width, (value, multiple) in widths.items():
        if value % multiple:
            return (f"{width}={value} is not a multiple of {multiple}, the "
                    f"kernel's vector width")
    for width, (value, most, vectors) in (limits or {}).items():
        if value > most:
            return f"{width}={value} is above {most}, {vectors} 16-byte vectors"
    return None


def check_fit(name: str, tensors: dict, error: str | None) -> None:
    """Raise ValueError unless every tensor starts on a 16-byte boundary
    and `error`, the verdict of the kernel's fit rule on the call's
    widths, is None."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} does not start on a 16-byte "
                             f"boundary")
    if error is not None:
        raise ValueError(f"{name}: {error}")


def check_stamps(name: str, stamps, B: int, device) -> None:
    """Raise ValueError unless `stamps` is None or an int64 tensor
    [CLUSTER_BLOCKS * B, STAMP_SLOTS] on `device`, where a cluster kernel
    writes each block's clock at the ends of its phases."""
    if stamps is None:
        return
    check_cuda(name, {"stamps": stamps}, dtype=torch.int64, device=device)
    if stamps.shape != (CLUSTER_BLOCKS * B, STAMP_SLOTS):
        raise ValueError(f"{name}: stamps {tuple(stamps.shape)}, expected "
                         f"({CLUSTER_BLOCKS * B}, {STAMP_SLOTS})")


def dtype_code(name: str, dtype: torch.dtype) -> int:
    if dtype not in DTYPE_CODES:
        raise ValueError(f"{name}: dtype {dtype} not supported "
                         f"(float32 or bfloat16)")
    return DTYPE_CODES[dtype]


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU: the wrappers then run the
    kernel's plain version. Any other mix goes to the kernel's checks."""
    return all(t.device.type == "cpu" for t in tensors)
