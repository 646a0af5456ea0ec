"""PNG and GIF files with the standard library and NumPy alone.

The JAX viewer writes PNGs through Pillow and GIFs through imageio
(nenbody_tpu/viz/viewer.py, nenbody_tpu/cli.py); the port writes the same
two formats itself, so a GPU host needs neither:

- PNG: 8-bit gray, RGB or RGBA, filter 0 on every row, one zlib stream at
  level 6, as native/nenhost.cpp's encoder writes it (the viewer hands
  frames to that library when it is built, utils.native); `read_png`
  decodes such files.
- GIF89a: one local palette of at most 256 colours per frame, LZW with
  8-bit minimum code size, a graphic control extension with the frame
  delay in hundredths of a second, and a NETSCAPE2.0 loop extension. A
  frame of at most 256 distinct colours is stored exactly; a frame with
  more is quantized to the 6 x 7 x 6 colour cube (`CUBE_LEVELS`), so every
  channel is within half a level step (`CUBE_STEP / 2`) of the frame's.
  `gif_info` walks a file's blocks (size, frames, delays, loop) without
  decoding the pixels.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import List, Sequence

import numpy as np

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
_PNG_COLOR = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_PNG_CHANNELS = {v: k for k, v in _PNG_COLOR.items()}


def _as_image(img: np.ndarray) -> np.ndarray:
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 2:
        img = img[:, :, None]
    if img.ndim != 3 or img.shape[2] not in _PNG_COLOR:
        raise ValueError(f"an image is [H, W] or [H, W, 1|3|4] uint8, got {img.shape}")
    return img


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """PNG file bytes of a uint8 [H, W] or [H, W, C] image (C 1, 3 or 4)."""
    img = _as_image(img)
    h, w, c = img.shape
    rows = np.zeros((h, 1 + w * c), np.uint8)  # filter byte 0, then the row
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _PNG_COLOR[c], 0, 0, 0)
    return (_PNG_SIG + _png_chunk(b"IHDR", ihdr)
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(png_bytes(img))


def read_png(data: bytes | str) -> np.ndarray:
    """Decode a PNG as png_bytes and native/nenhost.cpp write it (bytes or a
    path): 8-bit gray, RGB or RGBA, not interlaced, filter 0 on every row
    -> uint8 [H, W, C]. Raises ValueError on anything else."""
    if isinstance(data, (str, os.PathLike)):
        with open(data, "rb") as f:
            data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    off, idat, hdr = 8, [], None
    while off < len(data):
        (length,) = struct.unpack(">I", data[off:off + 4])
        kind, body = data[off + 4:off + 8], data[off + 8:off + 8 + length]
        (crc,) = struct.unpack(">I", data[off + 8 + length:off + 12 + length])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        off += 12 + length
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8 or color not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG depth {depth}, colour type {color}, interlace {interlace}: "
                         f"only 8-bit non-interlaced gray, RGB or RGBA")
    c = _PNG_CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + w * c)
    if raw[:, 0].any():
        raise ValueError("PNG rows with a filter other than 0")
    return raw[:, 1:].reshape(h, w, c).copy()


# -- GIF ------------------------------------------------------------------------

CUBE_LEVELS = (6, 7, 6)  # R, G, B levels of the quantizing palette (252 colours)
CUBE_STEP = tuple(255.0 / (n - 1) for n in CUBE_LEVELS)


def _palette_indices(rgb: np.ndarray):
    """(palette [256, 3] uint8, indices [H*W] uint8) of an RGB frame: its own
    colours when there are at most 256, else the colour cube's nearest."""
    flat = rgb.reshape(-1, 3)
    key = (flat[:, 0].astype(np.int32) << 16) | (flat[:, 1].astype(np.int32) << 8) | flat[:, 2]
    colours, inverse = np.unique(key, return_inverse=True)
    palette = np.zeros((256, 3), np.uint8)
    if len(colours) <= 256:
        palette[:len(colours)] = np.stack([colours >> 16, (colours >> 8) & 0xFF,
                                           colours & 0xFF], -1)
        return palette, inverse.reshape(-1).astype(np.uint8)
    lv = [np.rint(flat[:, c] / CUBE_STEP[c]).astype(np.int32) for c in range(3)]
    idx = (lv[0] * CUBE_LEVELS[1] + lv[1]) * CUBE_LEVELS[2] + lv[2]
    grid = np.stack(np.meshgrid(*[np.arange(n) for n in CUBE_LEVELS], indexing="ij"), -1)
    cube = np.rint(grid.reshape(-1, 3) * np.asarray(CUBE_STEP)).astype(np.uint8)
    palette[:len(cube)] = cube
    return palette, idx.astype(np.uint8)


def _lzw(indices: np.ndarray) -> bytes:
    """GIF LZW of 8-bit indices (minimum code size 8): codes of 9-12 bits,
    least significant bit first, a clear code first and whenever the table
    fills, an end code last."""
    clear, end = 256, 257
    out = bytearray()
    acc = nbits = 0

    def put(code: int, size: int) -> None:
        nonlocal acc, nbits
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8

    data = indices.tobytes()
    table: dict = {}
    next_code, size = 258, 9
    put(clear, size)
    w = data[0]
    for k in data[1:]:
        wk = (w << 8) | k  # codes < 4096 and k < 256: a unique int key
        code = table.get(wk)
        if code is not None:
            w = code
            continue
        put(w, size)
        if next_code < 4096:
            table[wk] = next_code
            next_code += 1
            # the decoder adds this entry one code later, then widens its
            # codes when its next free code reaches 2^size
            if next_code - 1 == 1 << size:
                size += 1
        else:
            put(clear, size)
            table.clear()
            next_code, size = 258, 9
        w = k
    put(w, size)
    put(end, size)
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def _sub_blocks(data: bytes) -> bytes:
    parts = [bytes([len(data[i:i + 255])]) + data[i:i + 255] for i in range(0, len(data), 255)]
    return b"".join(parts) + b"\x00"


def gif_bytes(frames: Sequence[np.ndarray], duration_ms: float, loop: int = 0) -> bytes:
    """GIF89a bytes of uint8 RGB frames [H, W, 3] of one size, each shown
    `duration_ms` (stored in hundredths of a second), repeated `loop` times
    after the first (0: forever)."""
    if not len(frames):
        raise ValueError("a GIF needs at least one frame")
    h, w = np.asarray(frames[0]).shape[:2]
    if not (0 < h < 1 << 16 and 0 < w < 1 << 16):
        raise ValueError(f"GIF frames are at most 65,535 pixels a side, got {h} x {w}")
    delay = int(round(duration_ms / 10.0))
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0x70, 0, 0),  # no global palette
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    for frame in frames:
        rgb = np.ascontiguousarray(frame, dtype=np.uint8)
        if rgb.shape != (h, w, 3):
            raise ValueError(f"GIF frames are uint8 [{h}, {w}, 3], got {rgb.shape}")
        palette, idx = _palette_indices(rgb)
        out += [b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00",
                b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0x87),  # local palette, 256
                palette.tobytes(), b"\x08", _sub_blocks(_lzw(idx))]
    out.append(b"\x3b")
    return b"".join(out)


def write_gif(path: str, frames: Sequence[np.ndarray], duration_ms: float, loop: int = 0) -> None:
    with open(path, "wb") as f:
        f.write(gif_bytes(frames, duration_ms, loop))


def gif_info(data: bytes | str) -> dict:
    """{"width", "height", "frames", "delays_ms" (one a frame), "loop"
    (None without a NETSCAPE2.0 block)} of a GIF file (bytes or a path),
    from its blocks alone."""
    if isinstance(data, (str, os.PathLike)):
        with open(data, "rb") as f:
            data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError("not a GIF file")
    w, h, flags = struct.unpack("<HHB", data[6:11])
    off = 13 + (3 << ((flags & 7) + 1) if flags & 0x80 else 0)

    def skip_sub_blocks(off: int) -> int:
        while data[off]:
            off += data[off] + 1
        return off + 1

    delays: List[float] = []
    frames, loop, delay = 0, None, 0.0
    while data[off] != 0x3B:
        if data[off] == 0x21:  # extension
            label = data[off + 1]
            if label == 0xF9:
                delay = 10.0 * struct.unpack("<H", data[off + 4:off + 6])[0]
            elif label == 0xFF and data[off + 3:off + 14] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", data[off + 16:off + 18])[0]
            off = skip_sub_blocks(off + 2)
        elif data[off] == 0x2C:  # image descriptor
            lflags = data[off + 9]
            off += 10 + (3 << ((lflags & 7) + 1) if lflags & 0x80 else 0)
            off = skip_sub_blocks(off + 1)  # the LZW minimum code size, then the data
            frames += 1
            delays.append(delay)
        else:
            raise ValueError(f"GIF: unknown block 0x{data[off]:02x} at {off}")
    return {"width": w, "height": h, "frames": frames, "delays_ms": delays, "loop": loop}
