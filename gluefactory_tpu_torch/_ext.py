"""Build and load the port's CUDA kernels and its host C++ code.

Each `csrc/<name>.cu` is compiled by nvcc on its own into
`_build/lib<name>-<hash>.so` (plain C interface, `sm_90a`) at first use and
loaded with ctypes. All sources build in parallel, one nvcc each. The hash
covers the source and the shared headers, so an edited kernel rebuilds.
Each `csrc/<name>.cpp` (host code, no CUDA: the image decoders) is compiled
the same way by the host C++ compiler (`$CXX`, else `c++` or `g++`) on the
CPU as on the card's machine; without a compiler `load_host` raises.
Nothing here runs at import time: this module imports on a machine without
CUDA, and only a launch on a CUDA tensor, or a decode, builds anything.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every C entry point, by library
SIGNATURES = {
    "lightglue_block": {
        "lg_proj": [_P, _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I,
                    _P, _P, _I, _I, _F, _I, _P],
        "lg_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "lg_ffn_tail": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    },
    "attention": {
        "at_attn_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _P],
        "at_cross_fwd_stacked": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        "at_cross_fwd_pair": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _F, _I, _P],
        "at_attn_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _F, _I, _I, _P],
        "at_attn_fwd_heads": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _P],
        "at_cross_fwd_heads": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _I,
                               _P],
    },
    "block0_conv": {
        "b0_block0": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    },
    "log_assignment": {
        "la_log_assignment": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _P],
    },
}

_I64 = ctypes.c_int64
# argument types of the host libraries' C entry points
HOST_SIGNATURES = {
    "image_decode": {
        "gf_jpeg_scan": [_P, _I64, _I, _P, _P, _P, _P, _I, _I, _I, _P],
        "gf_jpeg_idct": [_P, _I, _I, _P, _P],
        "gf_jpeg_upsample": [_P, _I, _I, _I, _I, _I, _P, _I, _I],
        "gf_jpeg_ycc_rgb": [_P, _P, _P, _I64, _P],
        "gf_png_unfilter": [_P, _I, _I64, _I, _P],
    },
}
HOST_FLAGS = ["-std=c++17", "-O2", "-shared", "-fPIC"]

_libs: dict = {}
_lock = threading.Lock()


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every kernel library that is not built yet, all nvcc
    processes at once. Returns {name: seconds} for the ones compiled."""
    names = list(names or SIGNATURES)
    BUILD.mkdir(parents=True, exist_ok=True)
    todo = {n: _target(n) for n in names if not _target(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name, target in todo.items():
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True), tmp)
    seconds, errors = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            tmp.replace(todo[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, argtypes in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def _cxx() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++"):
        path = cand and shutil.which(cand)
        if path:
            return path
    raise RuntimeError("no host C++ compiler found ($CXX, c++ or g++): the image decoders "
                       "(csrc/image_decode.cpp) build with one")


def _host_target(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes())
    h.update(" ".join(HOST_FLAGS).encode())
    return BUILD / f"lib{name}-host-{h.hexdigest()[:16]}.so"


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library `name` (`csrc/<name>.cpp`), built first if
    needed; raises if the compiler is missing or fails."""
    with _lock:
        lib = _libs.get(("host", name))
        if lib is None:
            target = _host_target(name)
            if not target.exists():
                BUILD.mkdir(parents=True, exist_ok=True)
                tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
                cmd = [_cxx(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cpp")]
                run = subprocess.run(cmd, capture_output=True, text=True)
                if run.returncode != 0:
                    raise RuntimeError(f"{cmd[0]} failed for {name}.cpp:\n{run.stderr}")
                tmp.replace(target)
            lib = ctypes.CDLL(str(target))
            for fn, argtypes in HOST_SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[("host", name)] = lib
        return lib


def check(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
