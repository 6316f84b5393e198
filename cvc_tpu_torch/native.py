"""ctypes bindings for the host's C++ libraries (the port of
`cvc_tpu/native.py`): the batch packer (`csrc/host/pack.cc`) and the
CIDEr-D scorer (`csrc/host/cider.cc`), the port's own copies of
`native/*.cc`.

Each library is built at first use with g++ (the flags of
`native/Makefile`; without OpenMP where the compiler has none) into
`cvc_tpu_torch/_build/host-<hash>/`, keyed on its source, the compiler
and the flags, and never loaded from `native/`. Where the build or
the load fails, the entry points return None and the callers take their
numpy or Python paths, as the JAX package's do; `available()` and
`cider_available()` say which path runs, so a caller that needs the C++
path can insist on it. The ABIs take per-example pointer tables, so
Python makes no staging copies.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "host"
_BUILD = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-Wall", "-Wextra", "-shared"]
OPENMP = ["-fopenmp"]
_lock = threading.Lock()
_libs: dict = {}
build_errors: dict = {}      # library -> the build's or the load's error
build_commands: dict = {}    # library -> the compiler and flags it was built with

_FP = ctypes.POINTER(ctypes.c_float)
_IP = ctypes.POINTER(ctypes.c_int32)
_LP = ctypes.POINTER(ctypes.c_int64)
_DP = ctypes.POINTER(ctypes.c_double)

_SOURCES = {"cvc_pack": "pack.cc", "cvc_cider": "cider.cc"}


def _compilers() -> list:
    """$CXX, then the g++ and c++ on PATH and the system's, each once."""
    seen, out = set(), []
    for c in (os.environ.get("CXX"), "g++", "c++", "/usr/bin/g++"):
        path = shutil.which(c) if c else None
        if path and os.path.realpath(path) not in seen:
            seen.add(os.path.realpath(path))
            out.append(path)
    return out


def _build(name: str) -> Path:
    """`_build/host-<hash>/lib<name>.so` from its source in `csrc/host/`,
    keyed on the source, the compiler and the flags. Each compiler is
    tried with OpenMP (the flags of `native/Makefile`), then without it
    (the `#pragma omp` loops then run on one thread: the same results);
    a library already built for an attempt is taken as it is, else it is
    built in a temporary directory and renamed into place. Raises
    RuntimeError with every attempt's error when none builds."""
    src = _SRC / _SOURCES[name]
    errors = []
    for extra in (OPENMP, []):
        for cxx in _compilers():
            cmd = [cxx, *CXX_FLAGS, *extra]
            h = hashlib.sha256(" ".join(cmd).encode())
            h.update(src.read_bytes())
            out = _BUILD / f"host-{h.hexdigest()[:16]}" / f"lib{name}.so"
            if not out.exists():
                _BUILD.mkdir(parents=True, exist_ok=True)
                work = Path(tempfile.mkdtemp(prefix="tmp-", dir=_BUILD))
                try:
                    lib = work / out.name
                    r = subprocess.run([*cmd, "-o", str(lib), str(src)],
                                       stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
                    if r.returncode != 0:
                        errors.append(f"{' '.join(cmd)}: {r.stdout}")
                        continue
                    out.parent.mkdir(parents=True, exist_ok=True)
                    os.replace(lib, out)
                finally:
                    shutil.rmtree(work, ignore_errors=True)
            build_commands[name] = " ".join(cmd)
            return out
    raise RuntimeError(f"no compiler built {src.name}:\n" + "\n".join(errors)
                       if errors else f"no C++ compiler found for {src.name}")


def _bind_pack(lib):
    lib.cvc_pack_batch.argtypes = [
        ctypes.POINTER(_FP), ctypes.POINTER(_FP), ctypes.POINTER(_IP),
        _IP, _IP,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _FP, _FP, _IP, _FP,
    ]
    lib.cvc_pack_tokens.argtypes = [
        ctypes.POINTER(_IP), _IP,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        _IP, _FP,
    ]
    lib.cvc_pack_version.restype = ctypes.c_int32
    if lib.cvc_pack_version() != 2:
        raise RuntimeError("cvc_pack_version != 2")


def _bind_cider(lib):
    lib.cvc_cider_df_build.restype = ctypes.c_void_p
    lib.cvc_cider_df_build.argtypes = [_IP, _LP, _LP, ctypes.c_int32,
                                       ctypes.c_int32]
    lib.cvc_cider_df_free.argtypes = [ctypes.c_void_p]
    lib.cvc_cider_score.argtypes = [
        _IP, _LP, _IP, _LP, _LP, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_double, ctypes.c_void_p, _DP,
    ]
    lib.cvc_cider_version.restype = ctypes.c_int32
    if lib.cvc_cider_version() != 1:
        raise RuntimeError("cvc_cider_version != 1")


def _load(name: str, bind):
    """The loaded library `name`, or None where it does not build or load
    (the error is kept in `build_errors`). Tried once a process."""
    with _lock:
        if name not in _libs:
            try:
                lib = ctypes.CDLL(str(_build(name)))
                bind(lib)
                _libs[name] = lib
            except Exception as e:       # the numpy / Python paths remain
                build_errors[name] = f"{type(e).__name__}: {e}"
                _libs[name] = None
        return _libs[name]


def available() -> bool:
    """Whether the C++ batch packer loads."""
    return _load("cvc_pack", _bind_pack) is not None


def cider_available() -> bool:
    """Whether the C++ CIDEr-D scorer loads."""
    return _load("cvc_cider", _bind_cider) is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def pack_batch_native(examples, num_frames: int, num_regions: int,
                      feat_dim: int, out=None):
    """examples: list of (feats [F,N,D] or [N,D], boxes [.,4], classes [.]).
    Returns (feats [B,S,D], geom [B,S,5], cls [B,S], mask [B,S]), or None
    where the library is unavailable. `out`: those four arrays to write
    into (C-contiguous float32, float32, int32, float32), every element
    written, e.g. the first B rows of a batch's buffers."""
    lib = _load("cvc_pack", _bind_pack)
    if lib is None:
        return None
    B = len(examples)
    S = num_frames * num_regions
    keep = []          # keeps the contiguous views alive through the call
    fptrs, bptrs, cptrs = (_FP * B)(), (_FP * B)(), (_IP * B)()
    frames = np.empty((B,), np.int32)
    regions = np.empty((B,), np.int32)
    for i, (f, b, c) in enumerate(examples):
        if f.ndim == 2:
            f, b, c = f[None], b[None], c[None]
        F, N = f.shape[0], f.shape[1]
        if f.shape[-1] != feat_dim:
            f = f[..., :feat_dim]
        fa = np.ascontiguousarray(f, np.float32)
        ba = np.ascontiguousarray(b, np.float32)
        ca = np.ascontiguousarray(c, np.int32)
        keep.extend((fa, ba, ca))
        fptrs[i] = _ptr(fa, ctypes.c_float)
        bptrs[i] = _ptr(ba, ctypes.c_float)
        cptrs[i] = _ptr(ca, ctypes.c_int32)
        frames[i], regions[i] = F, N

    if out is None:
        out = (np.empty((B, S, feat_dim), np.float32),
               np.empty((B, S, 5), np.float32), np.empty((B, S), np.int32),
               np.empty((B, S), np.float32))
    for a, shape, dt in zip(out, ((B, S, feat_dim), (B, S, 5), (B, S),
                                  (B, S)),
                            (np.float32, np.float32, np.int32, np.float32)):
        if (a.shape != shape or a.dtype != dt
                or not a.flags.c_contiguous):
            raise ValueError(f"out array {a.shape} {a.dtype} is not a "
                             f"C-contiguous {shape} {np.dtype(dt)}")
    out_feats, out_geom, out_cls, out_mask = out
    lib.cvc_pack_batch(
        fptrs, bptrs, cptrs,
        _ptr(frames, ctypes.c_int32), _ptr(regions, ctypes.c_int32),
        B, num_frames, num_regions, feat_dim,
        _ptr(out_feats, ctypes.c_float), _ptr(out_geom, ctypes.c_float),
        _ptr(out_cls, ctypes.c_int32), _ptr(out_mask, ctypes.c_float))
    del keep
    return out_feats, out_geom, out_cls, out_mask


def pack_tokens_native(id_lists, seq_length: int, max_tokens: int,
                       bos: int, eos: int, pad: int):
    """id_lists: list of int lists (vocabulary ids, unpadded). Returns
    (tokens [B,T] int32, mask [B,T] float32), or None."""
    lib = _load("cvc_pack", _bind_pack)
    if lib is None:
        return None
    B = len(id_lists)
    lengths = np.empty((B,), np.int32)
    arrs = []
    ptrs = (_IP * B)()
    for i, ids in enumerate(id_lists):
        a = np.ascontiguousarray(ids if len(ids) else [0], np.int32)
        arrs.append(a)
        ptrs[i] = _ptr(a, ctypes.c_int32)
        lengths[i] = len(ids)
    out_tokens = np.empty((B, max_tokens), np.int32)
    out_mask = np.empty((B, max_tokens), np.float32)
    lib.cvc_pack_tokens(
        ptrs, _ptr(lengths, ctypes.c_int32),
        B, seq_length, max_tokens, bos, eos, pad,
        _ptr(out_tokens, ctypes.c_int32), _ptr(out_mask, ctypes.c_float))
    del arrs
    return out_tokens, out_mask


# ---------------------------------------------------------------------------
# CIDEr-D (csrc/host/cider.cc)
# ---------------------------------------------------------------------------

def _flatten_ids(seqs):
    """list of id lists -> (flat int32 array, offsets int64 [n+1])."""
    off = np.zeros((len(seqs) + 1,), np.int64)
    for i, s in enumerate(seqs):
        off[i + 1] = off[i] + len(s)
    flat = (np.concatenate([np.asarray(s, np.int32) for s in seqs])
            if off[-1] else np.zeros((0,), np.int32))
    return np.ascontiguousarray(flat), off


def _flatten_ref_sets(ref_sets):
    """list (an image) of lists of id lists -> (flat, ref_off, img_off)."""
    all_refs = [r for refs in ref_sets for r in refs]
    flat, ref_off = _flatten_ids(all_refs)
    img_off = np.zeros((len(ref_sets) + 1,), np.int64)
    for i, refs in enumerate(ref_sets):
        img_off[i + 1] = img_off[i] + len(refs)
    return flat, ref_off, img_off


class NativeCiderDf:
    """A C++ document-frequency table over a corpus of reference sets (the
    SCST reward's training corpus). Raises RuntimeError where the library
    is unavailable."""

    def __init__(self, ref_sets_ids):
        lib = _load("cvc_cider", _bind_cider)
        if lib is None:
            raise RuntimeError("native CIDEr-D unavailable: "
                               + build_errors.get("cvc_cider", ""))
        flat, ref_off, img_off = _flatten_ref_sets(ref_sets_ids)
        self._lib = lib
        self._handle = lib.cvc_cider_df_build(
            _ptr(flat, ctypes.c_int32), _ptr(ref_off, ctypes.c_int64),
            _ptr(img_off, ctypes.c_int64), len(ref_sets_ids), 4)

    def __del__(self):
        handle = getattr(self, "_handle", None)
        if handle:
            self._lib.cvc_cider_df_free(handle)


def cider_score_native(cand_ids, ref_sets_ids, sigma: float = 6.0,
                       max_n: int = 4, df: "NativeCiderDf | None" = None):
    """cand_ids: a token-id list an image; ref_sets_ids: an image's list
    of reference id lists. Returns float64 [n_images] CIDEr-D (×10)
    scores, or None where the library is unavailable. `df`: a corpus
    table; None takes the document frequency over `ref_sets_ids`."""
    lib = _load("cvc_cider", _bind_cider)
    if lib is None:
        return None
    n = len(cand_ids)
    cflat, coff = _flatten_ids(cand_ids)
    rflat, roff, imgoff = _flatten_ref_sets(ref_sets_ids)
    out = np.empty((n,), np.float64)
    lib.cvc_cider_score(
        _ptr(cflat, ctypes.c_int32), _ptr(coff, ctypes.c_int64),
        _ptr(rflat, ctypes.c_int32), _ptr(roff, ctypes.c_int64),
        _ptr(imgoff, ctypes.c_int64), n, max_n, sigma,
        df._handle if df is not None else None, out.ctypes.data_as(_DP))
    return out
