"""Metric logging: JSONL scalars and PNG images always; TensorBoard where
it is installed.

Port of ``hyperbolic_vae_tpu/train/metrics.py``; names keep the
``train/ val/ test/`` prefixes (``val/loss_total``). Images are written
as PNG with the standard library (``zlib`` + ``struct``: not every
machine has PIL). With ``use_tensorboard`` (the default) and
``torch.utils.tensorboard`` importable, a ``SummaryWriter`` in
``log_dir`` also gets every scalar and image (HWC floats in [0, 1]);
without it, one info line says that the log is JSONL and PNG only.
"""

from __future__ import annotations

import json
import logging
import struct
import zlib
from pathlib import Path
from typing import Mapping, Optional

import numpy as np

logger = logging.getLogger(__name__)

# PNG colour type by channel count: grey, RGB, RGBA
_PNG_COLOR = {1: 0, 3: 2, 4: 6}


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_png(path, image: np.ndarray) -> None:
    """Write a uint8 (H, W) or (H, W, C) image, C in {1, 3, 4}, as an
    8-bit PNG (no filtering)."""
    arr = np.asarray(image, np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    if c not in _PNG_COLOR:
        raise ValueError(f"PNG takes 1, 3 or 4 channels, got {c}")
    raw = b"".join(b"\x00" + row.tobytes() for row in arr.reshape(h, w * c))
    header = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR[c], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(raw, 6)) + _png_chunk(b"IEND", b""))


def read_png(path) -> np.ndarray:
    """Read back a PNG written by ``write_png``: uint8 (H, W) for grey,
    else (H, W, C)."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path} is not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        if zlib.crc32(kind + body) & 0xFFFFFFFF != struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {kind!r}")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, color = header[:4]
    c = {v: k for k, v in _PNG_COLOR.items()}[color]
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * c)
    if depth != 8 or rows[:, 0].any():
        raise ValueError(f"{path}: only 8-bit unfiltered PNGs are read")
    img = rows[:, 1:].reshape(h, w, c)
    return img[..., 0] if c == 1 else img


class MetricLogger:
    """Appends ``{"step": epoch, name: value, ...}`` lines to
    ``log_dir/metrics.jsonl`` (and, with TensorBoard, event files there);
    does nothing without a ``log_dir``."""

    def __init__(self, log_dir: Optional[str] = None, use_tensorboard: bool = True):
        self.log_dir = Path(log_dir) if log_dir else None
        self._jsonl = None
        self._tb = None
        if self.log_dir:
            self.log_dir.mkdir(parents=True, exist_ok=True)
            self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
            if use_tensorboard:
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    logger.info("TensorBoard unavailable; JSONL metrics and PNG images only")
                else:
                    self._tb = SummaryWriter(log_dir=str(self.log_dir))

    def log_scalars(self, step: int, scalars: Mapping[str, float]) -> None:
        if self._jsonl:
            self._jsonl.write(json.dumps({"step": step, **{k: float(v) for k, v in scalars.items()}}) + "\n")
            self._jsonl.flush()
        if self._tb:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def log_image(self, step: int, tag: str, image) -> None:
        """image (H, W, C), uint8 or floats in [0, 1]: saved as
        ``log_dir/<tag>_<step:05d>.png`` (a single channel as grey)."""
        if self.log_dir:
            arr = np.asarray(image)
            if arr.dtype != np.uint8:
                arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
            write_png(self.log_dir / f"{tag.replace('/', '_')}_{step:05d}.png", arr)
        if self._tb:
            arr = np.asarray(image)
            arr = (arr.astype(np.float32) / 255.0 if arr.dtype == np.uint8
                   else np.clip(arr, 0, 1).astype(np.float32))
            self._tb.add_image(tag, arr, step, dataformats="HWC")

    def log_hparams(self, hparams: Mapping) -> None:
        if self.log_dir:
            with open(self.log_dir / "hparams.json", "w") as f:
                json.dump({k: repr(v) for k, v in hparams.items()}, f, indent=2)

    def close(self) -> None:
        if self._jsonl:
            self._jsonl.close()
            self._jsonl = None
        if self._tb:
            self._tb.close()
            self._tb = None
