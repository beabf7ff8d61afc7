"""Build the hand-written CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into `build/kernels/<name>-<hash>.so`
(the hash covers the source, the shared `csrc/*.cuh` headers and the
flags), at first use, for `sm_90a`.
The libraries expose plain C functions; pointers and the stream are passed
as `c_void_p`, and every function returns `cudaGetLastError()` after its
launch.  Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
#: the masked entries' frame ids, frame table, tile table and the Hopper
#: body's coarse table, then F
_MASK_SM90 = [_P, _P, _P, _P, _P, _I]

#: C signatures, by source name.  The backward entries take their 18
#: strides as a pointer to a `long long` array; the unmasked dKV entry
#: takes the fp32 workspace and the number of query splits after dK, dV;
#: P2 takes its tile width and Q its layout before the stream.
SIGNATURES = {
    "flash_fwd": {
        "mmpl_flash_fwd": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I]
                          + [_L] * 12 + [_F, _P],
        "mmpl_flash_masked_fwd": [_I, _P, _P, _P, _P, _P] + _MASK_SM90
                                 + [_I] * 5 + [_L] * 12 + [_F, _P],
        "mmpl_flash_exp2": [_I, _P, _P, _P, _P, _I, _I] + [_I] * 5
                           + [_L] * 12 + [_F, _P],
    },
    "flash_bwd": {
        "mmpl_flash_bwd_dkv": [_I] + [_P] * 9 + [_I] * 6 + [_P, _F, _P],
        "mmpl_flash_bwd_dq": [_I] + [_P] * 7 + [_I] * 5 + [_P, _F, _P],
        "mmpl_flash_masked_bwd_dkv": [_I] + [_P] * 8 + _MASK_SM90 + [_I] * 5
                                     + [_P, _F, _P],
        "mmpl_flash_masked_bwd_dq": [_I] + [_P] * 7 + _MASK_SM90 + [_I] * 5
                                    + [_P, _F, _P],
    },
    "int8_gemm": {
        "mmpl_int8_gemm": [_I] + [_P] * 5 + [_I] * 4 + [_P],
        "mmpl_quantize_rows": [_I, _P, _P, _P, _I, _I, _I, _P],
    },
}

_libs: Dict[str, ctypes.CDLL] = {}
#: seconds and ptxas report of each build done by this process
build_log: Dict[str, dict] = {}


def _nvcc() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cand = Path(os.environ[env]) / "bin" / "nvcc"
            if cand.exists():
                return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, dict]:
    """Compile every named source that is not built yet, all nvcc processes
    started together.  Returns {name: {"seconds", "ptxas", "path"}}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
        os.replace(tmp, out)
        build_log[name] = {"seconds": time.perf_counter() - t0,
                           "ptxas": log, "path": str(out)}
    return build_log


def library(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        out = _target(name)
        if not out.exists():
            build([name])
        lib = ctypes.CDLL(str(out))
        for fn, argtypes in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib
