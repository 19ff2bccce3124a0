"""Build and load the CUDA kernels of ``csrc/`` (nvcc -> shared library ->
ctypes), and count their launches.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles on its
own into ``build/kernels/<name>-<hash>.so`` at the repository root, where
``<hash>`` covers the source and the flags, so an edited source rebuilds.
The first call that needs a library builds every missing one, one
``nvcc`` process per source, all started together.  A missing ``nvcc`` or
a failed build raises; nothing falls back.

Launch counts: every wrapper adds one to ``LAUNCHES[<kernel name>]`` (for
a kernel's second addressing mode, ``<kernel name>[<mode>]``) where it
launches its kernel, and nowhere else, so a run can show that the main
path went through the kernels (``reset_launches`` sets them to 0).
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Dict, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
SOURCES = ("roll_kernels", "span_gather", "bucket_matmul", "scatter_level", "range_mark",
           "encode_io", "corner_sort")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
              "-shared", "-Xcompiler", "-fPIC")

LAUNCHES: collections.Counter = collections.Counter()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# Every C entry: its library (``csrc/<name>.cu``) and its arguments, the
# stream last.
ENTRIES: Dict[str, Tuple[str, list]] = {
    "nvr_roll_broadcast_fm": ("roll_kernels", [_P] * 3 + [_I] * 4 + [_L, _P]),
    "nvr_unroll_reduce_fm": ("roll_kernels", [_P] * 3 + [_I] * 4 + [_L, _L, _P]),
    "nvr_span_gather_sorted": ("span_gather", [_P] * 4 + [_I] * 5 + [_L, _L, _P]),
    "nvr_span_gather_table": ("span_gather", [_P] * 5 + [_I] * 5 + [_L, _L, _P]),
    "nvr_span_gather_point_order": ("span_gather", [_P] * 7 + [_I, _I, _L, _L, _P]),
    "nvr_bucket_grad_matmul": ("bucket_matmul", [_P] * 4 + [_I] * 4 + [_L] * 3 + [_P]),
    "nvr_scatter_level": ("scatter_level", [_P] * 4 + [_I, _L, _L, _L, _P]),
    "nvr_range_mark": ("range_mark", [_P] + [_I] * 5 + [_P]),
    "nvr_encode_index": ("encode_io", [_P] * 5 + [_I, _L, _L, _P]),
    "nvr_encode_grad_permute": ("encode_io", [_P] * 5 + [_I, _L, _P]),
    "nvr_unpack_feats": ("encode_io", [_P] * 2 + [_I, _L, _P]),
    "nvr_transpose_grad": ("encode_io", [_P] * 2 + [_I, _L, _P]),
    "nvr_xor_index": ("encode_io", [_P] * 7 + [_I, _L, _L, _P]),
    "nvr_corner_sort_scratch": ("corner_sort", [_L, _I, _I, _P, _P]),
    "nvr_corner_sort": ("corner_sort", [_P] * 6 + [_L, _P, _I, _L, _I, _P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[str, Callable[..., int]] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.access(path, os.X_OK):
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from csrc/ on first "
            "use and need the CUDA toolkit (nvcc on PATH or under CUDA_HOME)")
    return path


def lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, in
    parallel; return name -> path.  Raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: lib_path(n) for n in names}
    todo = [n for n in names if not paths[n].exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = paths[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{n}.cu:\n{out.decode(errors='replace')}")
        else:
            os.replace(tmp, paths[n])   # atomic: concurrent builds race safely
    if errors:
        raise RuntimeError("nvcc failed to build the CUDA kernels:\n"
                           + "\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library built from ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all()[name]))
        lib.nvr_error_string.argtypes = [ctypes.c_int]
        lib.nvr_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib


def _entry(symbol: str):
    """The C entry ``symbol`` with its ``argtypes`` (from ``ENTRIES``) and
    ``restype`` set, configured once and kept (a launch then costs one
    ctypes call)."""
    fn = _entries.get(symbol)
    if fn is None:
        name, argtypes = ENTRIES[symbol]
        fn = getattr(library(name), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _entries[symbol] = fn
    return fn


def launch(symbol: str, device: torch.device, *args) -> None:
    """Call the C entry ``symbol`` (one of ``ENTRIES``) on ``device``'s
    current stream (appended as the last argument) and raise if it returns
    a CUDA error (every entry returns ``cudaGetLastError()``)."""
    fn = _entry(symbol)
    if device.index is None or device.index == torch.cuda.current_device():
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    else:
        with torch.cuda.device(device):
            rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        name = ENTRIES[symbol][0]
        msg = library(name).nvr_error_string(rc).decode()
        raise RuntimeError(f"CUDA kernel in {name}.cu failed: {msg} ({rc})")


def require(cond: bool, msg: str) -> None:
    """Argument check of a kernel wrapper (raises; never falls back)."""
    if not cond:
        raise ValueError(msg)


def is_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU (plain path); False when all
    lie on one CUDA device (kernel path); raises for anything else."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = next(iter(devs))
    if dev.type == "cpu":
        return True
    if dev.type == "cuda":
        return False
    raise ValueError(f"unsupported device {dev}")
