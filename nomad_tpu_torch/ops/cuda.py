"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``nomad_tpu_torch/csrc/`` build with ``nvcc`` for
``sm_90a`` (Hopper) into one shared library with a plain C interface,
loaded with ``ctypes``. The build runs at first use, into
``nomad_tpu_torch/_build/<hash>/``, where the hash covers every source
and flag: a changed source builds anew, an unchanged one loads the
library already built. Each source compiles in its own ``nvcc``
process, all started together, and one more ``nvcc`` links them.

Nothing here runs at import: the tests import every module on a
machine with no ``nvcc`` and no card.

Every kernel wrapper counts its launches here (``count_launch``), one
per launch of its kernel and nowhere else, so a run can show which
kernels its main path went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from pathlib import Path
from typing import Dict, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
SOURCES = ("threefry.cu", "greedy_scan.cu", "uniform_topk.cu",
           "expand_overlay.cu", "base_delta.cu", "preempt_scan.cu",
           "gang_scan.cu", "convex_relax.cu", "convex_round.cu",
           "group_capacity.cu", "sharded_scan.cu", "sharded_topk.cu",
           "sharded_gang.cu", "sharded_relax.cu")
HEADERS = ("common.cuh", "gang.cuh", "relax.cuh")
LIB_NAME = "libnomad_kernels.so"
# The kernels' arithmetic rounds as the plain versions' separate tensor
# ops do through explicit round-to-nearest intrinsics (csrc/common.cuh),
# not a flag: powf then builds as it does in PyTorch's own kernels.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures (csrc/*.cu NT_API functions); every one returns the
# cudaError_t of its launch.
SIGNATURES: Dict[str, List] = {
    "nt_threefry_uniform": [_P, _P, _L, _L, _L, _L, _I, _F, _F, _P],
    "nt_greedy_scan": [_I, _I, _I, _I, _F, _I, _I] + [_P] * 21,
    "nt_uniform_topk": [_I, _I, _I, _I, _I, _F, _I, _I] + [_P] * 22,
    "nt_expand_overlay": [_I] * 7 + [_P] * 10,
    "nt_base_delta": [_I, _I, _I] + [_P] * 10,
    "nt_argmax_chain": [_I, _P, _P],
    "nt_preempt_scan": [_I, _I, _I, _F, _F] + [_P] * 27,
    "nt_gang_scan": [_I] * 5 + [_F] + [_P] * 23,
    "nt_mirror_descent": [_I] * 3 + [_P] * 14,
    "nt_convex_relax": [_I] * 6 + [_F, _I, _I] + [_P] * 29,
    "nt_convex_round": [_I, _I, _I, _I, _F, _I, _I] + [_P] * 22,
    "nt_group_partial": [_I, _I] + [_P] * 4,
    "nt_group_combine": [_I, _I] + [_P] * 3,
    "nt_shard_step": [_I] * 5 + [_F] + [_I] * 6 + [_P] * 22,
    "nt_shard_winner": [_I] * 6 + [_P] * 7,
    "nt_shard_topk": [_I] * 6 + [_F] + [_I] * 4 + [_P] * 22,
    "nt_shard_merge": [_I] * 7 + [_P] * 9,
    "nt_gang_units": [_I] * 3 + [_P] * 13,
    "nt_gang_pick": [_I] * 3 + [_P] * 5,
    "nt_gang_step": [_I] * 6 + [_F] + [_I] * 2 + [_P] * 22,
    "nt_gang_winner": [_I] * 2 + [_P] * 8,
    "nt_gang_finish": [_I] + [_P] * 6,
    "nt_srelax_prologue": [_I] * 5 + [_F] + [_I] * 2 + [_P] * 26,
    "nt_srelax_rows": [_I] * 3 + [_P] * 4,
    "nt_srelax_combine": [_I] * 3 + [_P] * 3,
    "nt_srelax_cols": [_I] * 3 + [_P] * 9,
    "nt_srelax_x": [_I] * 4 + [_P] * 7,
    "nt_srelax_max": [_I] * 3 + [_P] * 4,
    "nt_srelax_pref": [_I] * 3 + [_P] * 5,
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None  # guarded-by: _lock
_launches: Counter = Counter()  # guarded-by: _lock
build_info: Dict[str, object] = {}  # guarded-by: _lock


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    for path in candidates:
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def source_hash() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    """Compile every source in parallel, link, and return the library
    path. Writes the compiler's output (ptxas register and shared
    memory counts) to ``build.log`` beside the library."""
    nvcc = _nvcc()
    tmp = out_dir.with_name(out_dir.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = []
    for name in SOURCES:
        obj = tmp / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / name), "-o", str(obj)]
        procs.append((name, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log = []
    failed = []
    for name, _obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        (tmp / "build.log").write_text("\n".join(log))
        raise RuntimeError(
            f"nvcc failed on {failed}:\n" + "\n".join(log)[-6000:])
    lib = tmp / LIB_NAME
    link = subprocess.run(
        [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
         "-o", str(lib), *[str(obj) for _n, obj, _p in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"== link\n{link.stdout}")
    (tmp / "build.log").write_text("\n".join(log))
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout[-6000:])
    build_info["build_s"] = time.perf_counter() - t0
    try:
        os.replace(tmp, out_dir)
    except OSError:
        # Another process finished the same build first: use theirs.
        shutil.rmtree(tmp, ignore_errors=True)
    return out_dir / LIB_NAME


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it first if needed."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / source_hash()
        path = out_dir / LIB_NAME
        build_info["cached"] = path.exists()
        if not path.exists():
            BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            path = _build(out_dir)
        build_info["path"] = str(path)
        lib = ctypes.CDLL(str(path))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def launch(name: str, *args) -> None:
    """Call one C entry point on the current stream's arguments and
    raise if the launch was refused."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def count_launch(name: str, n: int = 1) -> None:
    """Count ``n`` launches of ``name`` (a wrapper that launches its
    kernel n times in one call counts them once, after the loop)."""
    with _lock:
        _launches[name] += n


def launch_counts() -> Dict[str, int]:
    with _lock:
        return dict(_launches)


def reset_launch_counts() -> None:
    with _lock:
        _launches.clear()


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
