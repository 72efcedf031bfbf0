"""ctypes bindings for the native I/O runtime (native/juicyio.cpp), for the
PyTorch port: juicy_tpu/runtime/native.py over the same library.

Builds ``native/libjuicyio.so`` with ``native/Makefile`` on first use (g++,
~1 s); ``load_corpus`` decodes with the Python reader (runtime/wav.py) when
no toolchain is there. The native layer covers the feed side of the
pipeline: corpus decode into a planar float32 arena [B, C, T], ready for
``torch.from_numpy``, and an SPSC ring buffer for the realtime host bridge
(runtime/host_bridge.py). The TPU tile emit (``load_corpus_tiles``) has no
counterpart: the port's kernels read the corpus as [B, C, T].
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

# the repository's native/, beside this package
_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libjuicyio.so"))
_lib: Optional[ctypes.CDLL] = None


class WavInfo(ctypes.Structure):
    _fields_ = [("channels", ctypes.c_int32),
                ("sample_rate", ctypes.c_int32),
                ("frames", ctypes.c_int64),
                ("format", ctypes.c_int32),
                ("bits", ctypes.c_int32)]


class HostStats(ctypes.Structure):
    _fields_ = [("blocks_pushed", ctypes.c_int64),
                ("blocks_popped", ctypes.c_int64),
                ("push_retries", ctypes.c_int64),
                ("elapsed_s", ctypes.c_double)]


def _build() -> bool:
    try:
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True, timeout=120)
        return os.path.exists(_LIB_PATH)
    except Exception:
        return False


def load_library(force_rebuild: bool = False) -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None and not force_rebuild:
        return _lib
    if not os.path.exists(_LIB_PATH) or force_rebuild:
        if not _build():
            return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.juicy_wav_info.argtypes = [ctypes.c_char_p, ctypes.POINTER(WavInfo)]
    lib.juicy_wav_info.restype = ctypes.c_int
    lib.juicy_wav_read.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64, ctypes.c_int32]
    lib.juicy_wav_read.restype = ctypes.c_int
    lib.juicy_wav_write_f32.argtypes = [ctypes.c_char_p,
                                        ctypes.POINTER(ctypes.c_float),
                                        ctypes.c_int64, ctypes.c_int32,
                                        ctypes.c_int32]
    lib.juicy_wav_write_f32.restype = ctypes.c_int
    lib.juicy_load_corpus.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                      ctypes.c_int32,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int64, ctypes.c_int32]
    lib.juicy_load_corpus.restype = ctypes.c_int
    lib.juicy_load_corpus_mt.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                         ctypes.c_int32,
                                         ctypes.POINTER(ctypes.c_float),
                                         ctypes.c_int64, ctypes.c_int32,
                                         ctypes.c_int32]
    lib.juicy_load_corpus_mt.restype = ctypes.c_int
    lib.juicy_ring_create.argtypes = [ctypes.c_int64]
    lib.juicy_ring_create.restype = ctypes.c_void_p
    lib.juicy_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.juicy_ring_readable.argtypes = [ctypes.c_void_p]
    lib.juicy_ring_readable.restype = ctypes.c_int64
    lib.juicy_ring_push.argtypes = [ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_float),
                                    ctypes.c_int64]
    lib.juicy_ring_push.restype = ctypes.c_int
    lib.juicy_ring_pop.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64]
    lib.juicy_ring_pop.restype = ctypes.c_int
    lib.juicy_host_stream.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_char_p, ctypes.c_char_p,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_int32, ctypes.c_int32,
                                      ctypes.c_double,
                                      ctypes.POINTER(HostStats)]
    lib.juicy_host_stream.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return load_library() is not None


def wav_info(path: str) -> Tuple[int, int, int]:
    """(channels, sample_rate, frames) via the native decoder."""
    lib = load_library()
    info = WavInfo()
    rc = lib.juicy_wav_info(path.encode(), ctypes.byref(info))
    if rc != 0:
        raise IOError(f"juicy_wav_info({path}) failed: {rc}")
    return info.channels, info.sample_rate, info.frames


def load_corpus(paths: List[str], frames: int, channels: int = 2,
                threads: int = 0) -> np.ndarray:
    """Decode WAV files into a planar float32 arena [B, C, T].

    Files shorter than `frames` are zero-padded; longer are truncated; mono
    is duplicated across channels. Decodes on `threads` host threads
    (0 = hardware concurrency — files are independent, so decode scales
    ~linearly with cores). Falls back to the Python decoder when the native
    library is unavailable.
    """
    lib = load_library()
    arena = np.zeros((len(paths), channels, frames), np.float32)
    if lib is not None:
        c_paths = (ctypes.c_char_p * len(paths))(*[p.encode() for p in paths])
        ok = lib.juicy_load_corpus_mt(
            c_paths, len(paths),
            arena.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            frames, channels, threads)
        if ok != len(paths):
            raise IOError(f"native corpus load decoded {ok}/{len(paths)} files")
        return arena
    from juicy_tpu_torch.runtime.wav import read_wav
    for i, p in enumerate(paths):
        audio, _ = read_wav(p)
        c = min(channels, audio.shape[0])
        t = min(frames, audio.shape[1])
        arena[i, :c, :t] = audio[:c, :t]
        if audio.shape[0] == 1 and channels > 1:
            arena[i, 1:, :t] = audio[0, :t]
    return arena


class RingBuffer:
    """SPSC float ring (realtime host bridge primitive)."""

    def __init__(self, capacity: int):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self._ptr = lib.juicy_ring_create(capacity)

    def push(self, x: np.ndarray) -> bool:
        x = np.ascontiguousarray(x, np.float32)
        rc = self._lib.juicy_ring_push(
            self._ptr, x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), x.size)
        return rc == 0

    def pop(self, n: int) -> Optional[np.ndarray]:
        out = np.empty(n, np.float32)
        rc = self._lib.juicy_ring_pop(
            self._ptr, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
        return out if rc == 0 else None

    def readable(self) -> int:
        return int(self._lib.juicy_ring_readable(self._ptr))

    def close(self):
        if self._ptr:
            self._lib.juicy_ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def host_stream(in_ring: "RingBuffer", out_ring: "RingBuffer",
                wav_path: str, out_path: str, channels: int, block: int,
                sr: int, realtime: bool = False,
                timeout_s: float = 60.0) -> dict:
    """Run the NATIVE host shim (native/juicyio.cpp juicy_host_stream): the
    audio-callback side of the ring protocol, streaming a WAV through a
    running bridge and writing the rendered WAV. Blocks until the stream
    drains; call from a worker thread (ctypes releases the GIL, so the
    exchange crosses a real native-thread boundary) while a HostBridge
    pumps the device side. Returns push/pop/pacing stats."""
    lib = load_library()
    if lib is None:
        raise RuntimeError("native library unavailable")
    stats = HostStats()
    rc = lib.juicy_host_stream(
        in_ring._ptr, out_ring._ptr, wav_path.encode(), out_path.encode(),
        channels, block, int(sr), 1 if realtime else 0,
        float(timeout_s), ctypes.byref(stats))
    if rc != 0:
        raise IOError(f"juicy_host_stream failed: {rc}")
    return {"blocks_pushed": int(stats.blocks_pushed),
            "blocks_popped": int(stats.blocks_popped),
            "push_retries": int(stats.push_retries),
            "elapsed_s": float(stats.elapsed_s)}
