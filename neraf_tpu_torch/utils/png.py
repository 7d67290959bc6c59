"""PNG files without PIL: what the data layer and the eval panels need.

- `read_png`: 8-bit grayscale, RGB and RGBA, non-interlaced, every filter
  type (None, Sub, Up, Average, Paeth) -> (H, W, C) uint8; `read_rgb`
  returns RGB, with gray replicated and alpha dropped, as PIL's
  ``convert("RGB")`` does.
- `write_png` / `encode_png`: (H, W, 3) uint8 -> an RGB8 PNG file / its
  bytes (filter None on every row); `quantize_rgb`: a render's rgb in
  [0, 1] -> uint8, as the JAX CLIs quantise it.
- `resize_bilinear`: PIL's ``Image.BILINEAR`` downscale as
  ``F.interpolate(mode="bilinear", antialias=True)`` rounded to 8-bit
  levels; it stays within one level of PIL's result at factors 2 and 4
  (tests/test_torch_data.py). PIL resizes RGBA premultiplied by alpha; here
  alpha is dropped first, so the two differ where alpha is below 255.
- `resize_nearest`: PIL's ``Image.NEAREST`` resize, its index mapping
  (each output pixel's source coordinate summed step by step in float64
  from half a step, then truncated) in numpy.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> channels (gray, RGB, RGBA)


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) != n:
            raise ValueError("truncated PNG chunk")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r}: CRC mismatch")
        yield kind, body
        pos += 12 + n


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The filtered scanlines (one filter byte, then `stride` bytes, a
    row) -> (height, stride) uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is too short")
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:  # Sub: a running sum along the row, per channel
            pad = (-stride) % bpp
            cols = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(cols, axis=0, dtype=np.uint64) % 256).astype(
                np.uint8).reshape(-1)[:stride]
        elif kind == 2:  # Up
            cur = line + prior
        elif kind in (3, 4):  # Average, Paeth: each byte needs its left one
            cur = bytearray(line.tobytes())
            up = prior.tolist()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (a + up[x]) >> 1
                else:
                    pred = _paeth(a, up[x], up[x - bpp] if x >= bpp else 0)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind} is not defined")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str | Path) -> np.ndarray:
    """An 8-bit gray, RGB or RGBA PNG -> (H, W, C) uint8, C = 1, 3 or 4."""
    data = Path(path).read_bytes()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(f"{path}: bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}: only 8-bit gray, RGB and "
                         "RGBA, non-interlaced, are read")
    c = _CHANNELS[colour]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * c, c)
    return pixels.reshape(height, width, c)


def read_rgb(path: str | Path) -> np.ndarray:
    """(H, W, 3) uint8: gray replicated, alpha dropped."""
    img = read_png(path)
    if img.shape[-1] == 1:
        return np.repeat(img, 3, axis=-1)
    return img[..., :3]


def write_png(path: str | Path, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an RGB8 PNG file."""
    Path(path).write_bytes(encode_png(rgb))


def quantize_rgb(rgb) -> np.ndarray:
    """(H, W, 3) rgb (a tensor on any device, or an array) -> uint8:
    clip(rgb, 0, 1) * 255 truncated, in float32 on the host."""
    if isinstance(rgb, torch.Tensor):
        rgb = rgb.float().cpu().numpy()
    return (np.clip(np.asarray(rgb, np.float32), 0, 1) * 255).astype(np.uint8)


def encode_png(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> the bytes of an RGB8 PNG."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    if rgb.ndim != 3 or rgb.shape[-1] != 3:
        raise ValueError(f"encode_png takes (H, W, 3) uint8, got {rgb.shape}")
    h, w, _ = rgb.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)],
                         axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    return (_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def resize_bilinear(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) uint8 -> (height, width, C) uint8, antialiased bilinear."""
    x = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    y = F.interpolate(x.to(torch.float32), size=(height, width),
                      mode="bilinear", antialias=True, align_corners=False)
    return y[0].permute(1, 2, 0).round().clamp(0, 255).to(torch.uint8).numpy()


def _nearest_rows(n_in: int, n_out: int) -> np.ndarray:
    """The source index of each of n_out pixels: PIL's ImagingScaleAffine
    starts at half a step and adds the step (n_in / n_out, float64) one
    pixel at a time, then truncates."""
    step = n_in / n_out
    pos = np.add.accumulate(np.concatenate([[step * 0.5],
                                            np.full(n_out - 1, step)]))
    return pos.astype(np.int64)


def resize_nearest(img: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H, W, C) -> (height, width, C), nearest neighbour as PIL picks it."""
    img = np.asarray(img)
    rows = _nearest_rows(img.shape[0], height)
    cols = _nearest_rows(img.shape[1], width)
    return img[rows[:, None], cols[None, :]]
