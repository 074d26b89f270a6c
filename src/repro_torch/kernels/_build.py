"""Build and load the port's CUDA kernels (plain C interface, ctypes).

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process for
``sm_90a`` into ``build/kernels/<name>-<hash>.so`` at the repository root
(override with ``REPRO_TORCH_BUILD_DIR``); the hash covers the source, the
shared header and the flags, so an edited source rebuilds and an unchanged
one is loaded as it is.  The first use builds every source at once, one
process each, all started together.  Nothing here runs at import time:
the CPU tests import every module on a machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
SOURCES = ("distance_topk", "grouped_distance_topk", "flash_attention", "flash_attention_wgmma")
FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the exported functions (all return a cudaError_t as int)
SIGNATURES = {
    "distance_topk": {
        "distance_topk_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
        "distance_topk_smem_optin": [],
    },
    "grouped_distance_topk": {
        "grouped_distance_topk_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P,
                                         _I, _I, _I, _I, _I, _I, _I, _P],
        "grouped_smem_optin": [],
    },
    "flash_attention": {
        "flash_attention_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _I, _P],
    },
    "flash_attention_wgmma": {
        "flash_attention_wgmma_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                         _L, _L, _L, _L, _L, _L, _L, _L, _L, _F, _I, _P],
        "flash_attention_wgmma_smem_bytes": [],
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# name -> nvcc's output (ptxas -v: registers, shared memory, spills) of the
# sources built by this process
build_logs: dict[str, str] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parents[1] / "build" / "kernels"


def nvcc_path() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return build_dir() / f"{name}-{h.hexdigest()[:16]}.so"


def build_all(verbose: bool = False) -> dict[str, Path]:
    """Compile every source whose library is missing or stale, one nvcc
    process per source, all in parallel.  Returns name -> library path;
    raises with the compiler's output if any build fails."""
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.is_file()}
    if todo:
        nvcc = nvcc_path()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = {}
        for name, tgt in todo.items():
            tmp = tgt.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *FLAGS, "-Xptxas", "-v", "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        failed = []
        for name, (tmp, p) in procs.items():
            out, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"--- nvcc {name}.cu (exit {p.returncode}):\n{out}")
                continue
            build_logs[name] = out
            if verbose:
                print(f"--- nvcc {name}.cu:\n{out}", flush=True)
            os.replace(tmp, todo[name])
        if failed:
            raise RuntimeError("CUDA kernel build failed\n" + "\n".join(failed))
    return targets


def lib(name: str) -> ctypes.CDLL:
    """The loaded library of one source (building all sources at first use)."""
    with _lock:
        if name not in _libs:
            paths = build_all()
            for n, p in paths.items():
                if n in _libs:
                    continue
                cdll = ctypes.CDLL(str(p))
                for fn, argtypes in SIGNATURES[n].items():
                    f = getattr(cdll, fn)
                    f.argtypes = argtypes
                    f.restype = ctypes.c_int
                _libs[n] = cdll
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
