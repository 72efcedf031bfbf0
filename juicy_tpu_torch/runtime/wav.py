"""WAV I/O (numpy and the standard library; PCM16/24/32 and float32).
A copy of juicy_tpu/runtime/wav.py for the PyTorch port: the same bytes
out, the same arrays in.

The reference has no file I/O (it is host-fed, JUCE AudioBuffer per callback);
the offline corpus mode needs it. A native C++ decoder for corpus-scale
ingest lives in native/ (runtime/native.py).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a WAV file → (float32 [C, T] in −1..1, sample_rate)."""
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            chunk = f.read(8)
            if len(chunk) < 8:
                break
            cid, size = chunk[:4], struct.unpack("<I", chunk[4:])[0]
            payload = f.read(size + (size & 1))
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", payload[:16])
            elif cid == b"data":
                data = payload[:size]
        if fmt is None or data is None:
            raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sr, _, _, bits = fmt
    if audio_format == 3 and bits == 32:           # IEEE float
        x = np.frombuffer(data, "<f4").astype(np.float32)
    elif audio_format in (1, 0xFFFE):
        if bits == 16:
            x = np.frombuffer(data, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(data, np.uint8).reshape(-1, 3)
            vals = (raw[:, 0].astype(np.int32)
                    | (raw[:, 1].astype(np.int32) << 8)
                    | (raw[:, 2].astype(np.int32) << 16))
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = vals.astype(np.float32) / float(1 << 23)
        elif bits == 32:
            x = np.frombuffer(data, "<i4").astype(np.float32) / float(1 << 31)
        else:
            raise ValueError(f"{path}: unsupported bit depth {bits}")
    else:
        raise ValueError(f"{path}: unsupported format {audio_format}")
    x = x.reshape(-1, channels).T.copy()
    return x, sr


def write_wav(path: str, audio: np.ndarray, sr: int, float32: bool = True):
    """Write float32 [C, T] audio to WAV (IEEE float32 or PCM16)."""
    audio = np.asarray(audio, np.float32)
    if audio.ndim == 1:
        audio = audio[None]
    channels, t = audio.shape
    interleaved = audio.T.reshape(-1)
    if float32:
        payload = interleaved.astype("<f4").tobytes()
        fmt_chunk = struct.pack("<HHIIHH", 3, channels, sr,
                                sr * channels * 4, channels * 4, 32)
    else:
        pcm = np.clip(interleaved, -1.0, 1.0)
        payload = (pcm * 32767.0).astype("<i2").tobytes()
        fmt_chunk = struct.pack("<HHIIHH", 1, channels, sr,
                                sr * channels * 2, channels * 2, 16)
    with open(path, "wb") as f:
        data_size = len(payload)
        f.write(b"RIFF")
        f.write(struct.pack("<I", 4 + 8 + len(fmt_chunk) + 8 + data_size))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<I", len(fmt_chunk)))
        f.write(fmt_chunk)
        f.write(b"data")
        f.write(struct.pack("<I", data_size))
        f.write(payload)
