"""Build the CUDA kernels of ``juicy_tpu_torch/csrc`` with nvcc at first use
and load them with ctypes.

The library is a plain C interface (no PyTorch headers), so a build takes
seconds: each source compiles in its own nvcc process, all started
together, and one more links them. It lands in ``juicy_tpu_torch/build/``
(git-ignored), named by a hash of the sources and flags: a changed source rebuilds, an unchanged one
loads what is there. A file lock serializes builds across the processes of a
parallel test run. Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

# -fmad=false: nvcc would otherwise contract a*b + c into one FMA, and the
# analyzer's envelope update feeds a threshold comparison where one ulp can
# flip an onset. No fast math: every transcendental is in precise.cuh.
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-fmad=false",
                 "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = (*ARCH_FLAGS, "-shared")


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def source_hash() -> str:
    """Hash of every source file's name and bytes, and the flags."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode() + b"\0" + p.read_bytes() + b"\0")
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ((Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
                 shutil.which("nvcc"), Path("/usr/local/cuda/bin/nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "build only where the CUDA toolkit is installed")


def library_path() -> Path:
    return BUILD_DIR / f"libjuicy_kernels_{source_hash()}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one shared library unless the
    library for the current sources exists: one nvcc per source, all
    started together, then one link. Returns its path; the nvcc output
    (ptxas register counts included) is kept beside it as ``.log``."""
    so = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            _compile_and_link(find_nvcc(), so)
    return so


def _compile_and_link(nvcc: str, so: Path):
    tag = f"{so.stem}.{os.getpid()}"
    jobs = []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, "-I", str(SRC_DIR), "-c", "-o", str(obj),
               str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _obj, proc in jobs:
        out, err = proc.communicate()
        log += [" ".join(cmd), out, err]
        if proc.returncode:
            failed.append(f"{cmd[-1]}: code {proc.returncode}\n{err}")
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, *LINK_FLAGS, "-o", str(tmp),
               *(str(obj) for _cmd, obj, _p in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log += [" ".join(cmd), proc.stdout, proc.stderr]
        if proc.returncode:
            failed.append(f"link: code {proc.returncode}\n{proc.stderr}")
    for _cmd, obj, _p in jobs:
        obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text("\n".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    os.replace(tmp, so)


def build_log() -> str:
    """The nvcc output of the current library's build."""
    return library_path().with_suffix(".log").read_text()


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare every entry point's C signature."""
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.juicy_saturator_stage.argtypes = (
        [ptr] * 9 + [i32] * 3 + [f32] * 12 + [ptr])
    lib.juicy_saturator_stage.restype = i32
    u32 = ctypes.c_uint32
    lib.juicy_texture_stage.argtypes = (
        [ptr] * 16 + [i32] * 5 + [u32] * 2 + [ptr, i32, ptr])
    lib.juicy_texture_stage.restype = i32
    lib.juicy_texture_stage_mixed.argtypes = (
        [ptr] * 16 + [i32] * 4 + [ptr, i32] + [u32] * 2 + [ptr, i32, ptr])
    lib.juicy_texture_stage_mixed.restype = i32
    lib.juicy_punch_stage.argtypes = [ptr] * 9 + [i32] * 3 + [ptr, i32, ptr]
    lib.juicy_punch_stage.restype = i32
    lib.juicy_motion_stage.argtypes = (
        [ptr] * 15 + [i32] * 5 + [ptr, i32, ptr])
    lib.juicy_motion_stage.restype = i32
    lib.juicy_chain_block.argtypes = (
        [ptr] * 5 + [i32] * 2 + [ptr] * 17 + [i32] * 7 + [u32] * 2
        + [i32] * 2 + [ptr])
    lib.juicy_chain_block.restype = i32
    lib.juicy_chain_block_mixed.argtypes = (
        list(lib.juicy_chain_block.argtypes[:-1]) + [ptr, ptr])
    lib.juicy_chain_block_mixed.restype = i32
    lib.juicy_chain_geometry.argtypes = [i32, i32, ptr]
    lib.juicy_chain_geometry.restype = i32
    lib.juicy_chain_mixed_geometry.argtypes = [i32, ptr]
    lib.juicy_chain_mixed_geometry.restype = i32
    for name in ("juicy_saturator_geometry", "juicy_motion_geometry"):
        getattr(lib, name).argtypes = [i32, i32, ptr]
        getattr(lib, name).restype = i32
    lib.juicy_punch_geometry.argtypes = [i32, i32, ptr]
    lib.juicy_punch_geometry.restype = i32
    for name in ("juicy_texture_geometry", "juicy_texture_mixed_geometry"):
        getattr(lib, name).argtypes = [i32, i32, i32, ptr]
        getattr(lib, name).restype = i32
    lib.juicy_analyzer_block.argtypes = [ptr] * 4 + [i32] * 3 + [f32] * 7 + [ptr]
    lib.juicy_analyzer_block.restype = i32
    lib.juicy_analyzer_geometry.argtypes = [i32, i32, ptr]
    lib.juicy_analyzer_geometry.restype = i32
    lib.juicy_ema_scan.argtypes = [ptr] * 9 + [i32] * 3 + [ptr]
    lib.juicy_ema_scan.restype = i32
    lib.juicy_cuda_error_string.argtypes = [i32]
    lib.juicy_cuda_error_string.restype = ctypes.c_char_p
    return lib


def error_string(lib: ctypes.CDLL, err: int) -> str:
    return lib.juicy_cuda_error_string(err).decode()
