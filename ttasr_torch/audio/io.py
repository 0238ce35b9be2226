"""Host-side audio decode/encode (the port's copy of ``ttasr/audio/io.py``).

``load_audio`` is the drop-in for ``librosa.load(path, sr=16000, mono=True)``
(reference asr_core.py:156, api/file_asr.py:271,455): returns a contiguous
float32 mono array at the requested rate.  WAV files decode in-process
(numpy); mp3/flac/m4a/aac decode through an ``ffmpeg`` subprocess when the
binary exists, since those codecs have no sane pure-Python path.
``probe_num_samples`` (training's length-grouped batching) is the
original's too; the streaming writer of the original stays with its slice.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import wave
from typing import Optional, Tuple, Union

import numpy as np

from ttasr_torch.audio.resample import resample_poly_host

AUDIO_EXTENSIONS = (".wav", ".mp3", ".flac", ".m4a", ".aac")


def pcm16_bytes_to_float32(data: bytes) -> np.ndarray:
    """Little-endian int16 PCM bytes -> float32 in [-1, 1)."""
    return np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0


def float32_to_pcm16_bytes(audio: np.ndarray) -> bytes:
    clipped = np.clip(audio, -1.0, 1.0)
    return (clipped * 32767.0).astype("<i2").tobytes()


def read_wav_bytes(data: bytes, *, int16: bool = False
                   ) -> Tuple[np.ndarray, int]:
    """Parse a RIFF/WAVE byte string -> (float32 [channels, n] or [n], rate).

    Supports PCM 8/16/24/32-bit and IEEE float32/64.  ``int16=True``
    returns mono PCM16 payloads as raw ``int16`` (no /32768 scaling) so
    they can upload to the device unconverted — half the relay bytes;
    every other layout still decodes to float32.
    """
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE stream")
    pos = 12
    fmt = None
    payload = None
    while pos + 8 <= len(data):
        chunk_id = data[pos : pos + 4]
        (size,) = struct.unpack("<I", data[pos + 4 : pos + 8])
        body = data[pos + 8 : pos + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif chunk_id == b"data":
            payload = body
        pos += 8 + size + (size & 1)
    if fmt is None or payload is None:
        raise ValueError("WAV missing fmt/data chunk")
    audio_format, channels, rate, _, _, bits = fmt
    if audio_format == 0xFFFE and len(payload) >= 0:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = 1
    if audio_format == 1:  # integer PCM
        if bits == 16:
            raw16 = np.frombuffer(payload, dtype="<i2")
            if int16 and channels == 1:
                # copy: frombuffer views are read-only, and the float
                # path always returns a writable array
                return raw16.copy(), rate
            samples = raw16.astype(np.float32) / 32768.0
        elif bits == 32:
            samples = np.frombuffer(payload, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 8:
            samples = (np.frombuffer(payload, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        elif bits == 24:
            raw = np.frombuffer(payload, dtype=np.uint8).reshape(-1, 3)
            ints = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            ints = np.where(ints >= 1 << 23, ints - (1 << 24), ints)
            samples = ints.astype(np.float32) / float(1 << 23)
        else:
            raise ValueError(f"unsupported PCM bit depth: {bits}")
    elif audio_format == 3:  # IEEE float
        dtype = "<f4" if bits == 32 else "<f8"
        samples = np.frombuffer(payload, dtype=dtype).astype(np.float32)
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")
    if channels > 1:
        samples = samples[: len(samples) - len(samples) % channels]
        samples = samples.reshape(-1, channels).T
    return samples, rate


def _decode_via_ffmpeg(path: str, sr: int, *, int16: bool = False
                       ) -> np.ndarray:
    ffmpeg = shutil.which("ffmpeg")
    if not ffmpeg:
        raise RuntimeError(
            f"cannot decode {os.path.splitext(path)[1]} without ffmpeg; "
            "install ffmpeg or provide WAV input"
        )
    cmd = [
        ffmpeg, "-nostdin", "-threads", "2", "-i", path,
        "-f", "s16le", "-ac", "1", "-acodec", "pcm_s16le", "-ar", str(sr), "-",
    ]
    proc = subprocess.run(cmd, capture_output=True, check=False)
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg decode failed: {proc.stderr[-500:].decode(errors='replace')}")
    if int16:  # already s16le mono at the target rate: keep PCM16
        return np.frombuffer(proc.stdout, dtype="<i2").copy()
    return pcm16_bytes_to_float32(proc.stdout)


def load_audio(
    path_or_bytes: Union[str, bytes],
    sr: int = 16000,
    mono: bool = True,
    int16: bool = False,
) -> Tuple[np.ndarray, int]:
    """Decode an audio file to float32 at ``sr`` Hz.

    Returns ``(audio, sr)`` like librosa.load.  ``mono=True`` averages
    channels; the result is C-contiguous float32 — unless ``int16=True``
    AND the source decodes losslessly to mono PCM16 at ``sr``, in which
    case raw int16 samples return instead (the engine uploads them
    unconverted; the device does the exact /32768 — PERF_NOTES.md int16
    PCM transfer).
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
        audio, native_sr = read_wav_bytes(data, int16=int16)
    else:
        ext = os.path.splitext(path_or_bytes)[1].lower()
        if ext == ".wav":
            with open(path_or_bytes, "rb") as fh:
                audio, native_sr = read_wav_bytes(fh.read(), int16=int16)
        else:
            return np.ascontiguousarray(
                _decode_via_ffmpeg(path_or_bytes, sr, int16=int16)), sr
    if audio.ndim > 1 and mono:
        audio = audio.mean(axis=0)
    if native_sr != sr:
        if audio.dtype == np.int16:
            audio = audio.astype(np.float32) / 32768.0
        audio = resample_poly_host(audio, native_sr, sr)
    if audio.dtype == np.int16:
        return np.ascontiguousarray(audio), sr
    return np.ascontiguousarray(audio, dtype=np.float32), sr


def probe_num_samples(path: str, sr: int = 16000) -> int:
    """Sample count at ``sr`` Hz without decoding when possible.

    WAV: header-only (``wave`` stdlib).  Other containers: ffprobe
    duration, falling back to a full decode.  Used for length-grouped
    batching (reference run.sh:33 ``group_by_length`` — HF sorts by the
    decoded ``input_length``; a header probe gives the same ordering
    without decoding the whole corpus up front).
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        try:
            import wave

            with wave.open(path, "rb") as wf:
                return int(wf.getnframes() * sr / wf.getframerate())
        except Exception:
            pass
    ffprobe = shutil.which("ffprobe")
    if ffprobe:
        proc = subprocess.run(
            [ffprobe, "-v", "quiet", "-show_entries", "format=duration",
             "-of", "csv=p=0", path],
            capture_output=True, text=True, check=False,
        )
        try:
            return int(float(proc.stdout.strip()) * sr)
        except ValueError:
            pass
    audio, _ = load_audio(path, sr=sr)
    return len(audio)


def write_wav(path: str, audio: np.ndarray, sr: int = 16000) -> None:
    """Write float32 mono audio as 16-bit PCM WAV."""
    with wave.open(path, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(float32_to_pcm16_bytes(np.asarray(audio)))
