"""Build and load the port's CUDA kernels, and count their launches.

The sources in ``spark_rapids_tpu_torch/csrc/*.cu`` have a plain C
interface.  At first use, one ``nvcc`` per source compiles them in parallel
for ``sm_90a``, one more links the objects into a shared library under
``spark_rapids_tpu_torch/_build/`` (named by a hash of the sources, the
headers they share and the flags, so an edit rebuilds), and ``ctypes``
loads it.  Nothing is built or
imported when this module is imported: the CPU tests import every module
and have no CUDA toolkit.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("selection.cu", "reduction.cu", "hash.cu", "sort.cu",
           "strings.cu", "join.cu", "fused.cu", "decimal.cu", "window.cu")
HEADERS = ("scan.cuh", "strings.cuh", "int128.cuh", "decimal.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

#: launches per kernel wrapper: each wrapper adds one where it launches its
#: kernel on the card, and nowhere else (the plain CPU versions do not count)
LAUNCHES: "collections.Counter[str]" = collections.Counter()

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
_SIGNATURES = {
    "srt_compaction_tile": [],
    "srt_max_gather_cols": [],
    "srt_compaction_count": [_P, _I64, _P, _P, _P],
    "srt_compaction_scatter": [_P, _I64, _P, _P, _P],
    "srt_scan_tile": [],
    "srt_gather": [_I, _P, _P, _P, _P, _P, _I64, _P, _I64, _P, _P, _P],
    "srt_gather_bytes": [_I, _P, _P, _P, _P, _P, _I64, _I, _P],
    "srt_concat": [_P, _P, _I, _I, _P, _P, _I64, _P],
    "srt_concat_string_bases": [_P, _P, _I, _P, _P],
    "srt_concat_strings": [_P, _P, _P, _I, _P, _P, _P, _I64, _I64, _P],
    "srt_reduction_tile": [],
    "srt_masked_sum": [_I, _P, _P, _I64, _P, _P, _P, _P, _P, _P],
    "srt_segment_tile": [],
    "srt_segmented_sum": [_I, _P, _P, _I64, _P, _I, _P, _P, _P, _P, _P, _P,
                          _P],
    "srt_reduce_state_bytes": [],
    "srt_segmented_extreme": [_I, _I, _P, _P, _I64, _P, _I, _P, _P, _P, _P],
    "srt_masked_extreme": [_I, _I, _P, _P, _I64, _P, _P, _P, _P, _P],
    "srt_segmented_m2": [_I, _I, _P, _P, _P, _P, _I64, _P, _I, _P, _P, _P,
                         _P, _P],
    "srt_masked_m2": [_I, _I, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P],
    "srt_segmented_pick": [_I, _I, _I, _P, _P, _P, _I64, _P, _I, _P, _P, _P],
    "srt_masked_pick": [_I, _I, _I, _P, _P, _P, _I64, _P, _P, _P],
    "srt_segmented_bitwise": [_I, _I, _P, _P, _I64, _P, _I, _P, _P, _P, _P],
    "srt_masked_bitwise": [_I, _I, _P, _P, _I64, _P, _P, _P, _P],
    "srt_segmented_sum128": [_P, _I, _P, _P, _I64, _P, _I, _I, _P, _P, _P,
                             _P, _P],
    "srt_masked_sum128": [_P, _I, _P, _P, _I64, _I, _P, _P, _P, _P, _P],
    "srt_segmented_extreme128": [_I, _P, _I, _P, _I64, _P, _I, _P, _P, _P,
                                 _P],
    "srt_masked_extreme128": [_I, _P, _I, _P, _I64, _P, _P, _P, _P],
    "srt_decimal128_binary": [_I, _P, _I, _P, _P, _I, _P, _I64, _I, _I, _I,
                              _I, ctypes.c_double, _P, _P, _P],
    "srt_decimal128_divide": [_P, _I, _P, _P, _I, _P, _I64, _I64, _I64, _I,
                              _I, _I, _I, _P, _P, _P],
    "srt_max_hash_cols": [],
    "srt_murmur3": [_I, _P, _P, _P, _P, _I64, ctypes.c_uint32, _P, _I, _P,
                    _P],
    "srt_sort_tile": [],
    "srt_max_radix_bits": [],
    "srt_partition": [_P, _I64, _I, _P, _P, _P, _P, _P, _P, _P, _P],
    "srt_null_counts": [_I, _P, _I64, _P, _P],
    "srt_sort_column": [_I, _P, _P, _I, _I, _I, _I, _P, _I64, _P, _P, _P, _P,
                        _P, _P, _P],
    "srt_string_sort_keys": [_P, _P, _P, _I64, _I, _P, _P, _P],
    "srt_string_max_length": [_P, _P, _I64, _P, _P],
    "srt_string_rows_equal_prev": [_P, _P, _P, _I64, _P, _P],
    "srt_substring_rows": [_P, _P, _P, _I64, _P, _I, _P, _I, _P, _P, _P, _P,
                           _P],
    "srt_join_scan_tile": [],
    "srt_join_build_keys": [_I, _P, _P, _P, _I64, _P, _P, _P],
    "srt_join_probe": [_I, _P, _P, _I64, _P, _P, _I64, _I, _P, _P, _P, _P,
                       _P],
    "srt_join_expand": [_P, _P, _P, _I64, _P, _P, _P],
    "srt_join_expand_left_only": [_P, _I64, _P, _P],
    "srt_join_max_keys": [],
    "srt_join_key_words": [_I, _P, _P, _P, _P, _P, _P, _I64, _I, _P, _P, _P],
    "srt_join_multi_probe": [_I, _P, _P, _P, _P, _P, _I64, _I, _P, _P, _P, _P,
                             _I64, _I, _P, _P, _P, _P, _P],
    "srt_cond_join_tile": [],
    "srt_cond_join_count": [_I, _I, _P, _P, _P, _I64, _P, _I64, _P, _I64, _P,
                            _P, _P, _P, _P, _P],
    "srt_cond_join_scatter": [_I, _I, _P, _P, _P, _I64, _P, _I64, _P, _I64,
                              _P, _P, _P, _P, _P, _P],
    "srt_fused_tile": [],
    "srt_fused_count": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _I64, _P, _P, _P,
                        _P],
    "srt_fused_write": [_P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P,
                        _I64, _P, _P, _P],
    "srt_fused_global": [_P, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _I64,
                         _P, _P, _P, _P, _P],
    "srt_window_tile": [],
    "srt_window_state_bytes": [_I],
    "srt_window_layout": [_P, _P, _I64, _P, _P, _P, _P, _P, _P, _P],
    "srt_frame_sum": [_I, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P, _P,
                      _P, _P, _P, _P],
    "srt_range_frame_bounds": [_I, _P, _P, _P, _I64, _I, _I64, _I, _I64, _P,
                               _P, _P],
    "srt_frame_extreme": [_I, _I, _P, _P, _I64, _P, _P, _I, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsrt_kernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources (in parallel) and link them; return the library.

    A library that already exists for these sources is reused."""
    out = _library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{Path(s).stem}-{tag}.o" for s in SOURCES]
    logs = [o.with_suffix(".log") for o in objs]
    procs = []
    for s, o, log in zip(SOURCES, objs, logs):
        with open(log, "w") as f:   # a file, not a pipe: no pipe can fill
            procs.append(subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", str(CSRC / s), "-o", str(o)],
                stdout=f, stderr=subprocess.STDOUT))
    codes = [p.wait() for p in procs]
    failed = [f"--- {s}\n{log.read_text()}"
              for s, code, log in zip(SOURCES, codes, logs) if code != 0]
    for log in logs:
        log.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    tmp = out.with_suffix(f".{tag}.tmp")
    link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                           *map(str, objs)], capture_output=True, text=True)
    for o in objs:
        o.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}{link.stderr}")
    os.replace(tmp, out)   # atomic: a concurrent build sees all or nothing
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def require_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous CUDA tensor."""
    for t in tensors:
        if t.device.type != "cuda":
            raise ValueError(f"{name}: tensor on {t.device}, expected cuda")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor must be contiguous")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())
