"""Image I/O: LDR via PIL, Radiance .hdr via a self-contained parser.

Mirrors mo_vk/src/texture.rs:74-102 (`load_from_file`): LDR images load as
rgba8, HDR as rgba32f.  Output arrays are (H, W, 4) numpy, row 0 = top.
"""

from __future__ import annotations

import io
import os

import numpy as np


def load_ldr(path_or_bytes) -> np.ndarray:
    """Load an LDR image (png/jpg/...) as (H, W, 4) uint8."""
    from PIL import Image

    if isinstance(path_or_bytes, (bytes, bytearray, memoryview)):
        img = Image.open(io.BytesIO(bytes(path_or_bytes)))
    else:
        img = Image.open(path_or_bytes)
    img = img.convert("RGBA")
    return np.asarray(img, dtype=np.uint8)


def load_hdr(path: str) -> np.ndarray:
    """Load a Radiance RGBE (.hdr) file as (H, W, 4) float32 (alpha = 1).

    Supports the common `-Y H +X W` orientation and both RLE-compressed and
    flat scanlines.  Matches the decode the reference gets from the `image`
    crate (texture.rs:84-89, Rgba32F path).
    """
    with open(path, "rb") as f:
        data = f.read()
    # native fast path (native/mo_native.cpp), identical decode
    from ..native import hdr_decode_rgbe

    native = hdr_decode_rgbe(data)
    if native is not None:
        return rgbe_to_float(native)
    # --- header
    if not (data.startswith(b"#?RADIANCE") or data.startswith(b"#?RGBE")):
        raise ValueError(f"{path}: not a Radiance HDR file")
    pos = 0
    lines = []
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
        lines.append(line)
    # resolution line
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported HDR orientation {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    p = pos
    for y in range(height):
        # New-style RLE scanline: 0x02 0x02 hi lo
        if (
            width >= 8
            and width < 32768
            and buf[p] == 2
            and buf[p + 1] == 2
            and ((int(buf[p + 2]) << 8) | int(buf[p + 3])) == width
        ):
            p += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[p])
                    p += 1
                    if count > 128:  # run
                        rgbe[y, x : x + count - 128, c] = buf[p]
                        p += 1
                        x += count - 128
                    else:  # literal
                        rgbe[y, x : x + count, c] = buf[p : p + count]
                        p += count
                        x += count
        else:
            # Flat scanline (possibly old-style RLE, which we don't expect in
            # modern assets; treat as flat RGBE quadruples).
            row = buf[p : p + width * 4].reshape(width, 4)
            rgbe[y] = row
            p += width * 4

    return rgbe_to_float(rgbe)


def rgbe_to_float(rgbe: np.ndarray) -> np.ndarray:
    """(H, W, 4) uint8 RGBE -> (H, W, 4) float32 linear radiance."""
    rgbe = rgbe.astype(np.float32)
    e = rgbe[..., 3]
    scale = np.where(e == 0.0, 0.0, np.ldexp(1.0, (e - 136.0).astype(np.int32)))
    out = np.empty(rgbe.shape, dtype=np.float32)
    # v = c * 2^(e-136), matching the Rust `image` crate / stb_image decode
    # used by the reference (texture.rs:84-89).
    out[..., :3] = rgbe[..., :3] * scale[..., None]
    out[..., 3] = 1.0
    return out


def write_png(path: str, image: np.ndarray):
    """Write (H, W, 3|4) uint8 (or float in [0,1]) image to PNG."""
    from PIL import Image

    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(np.asarray(arr, np.float32) * 255.0 + 0.5, 0, 255).astype(
            np.uint8
        )
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(arr).save(path)


def resize_rgba(image: np.ndarray, size: int) -> np.ndarray:
    """Bilinear-resize (H, W, 4) to (size, size, 4), preserving dtype."""
    from PIL import Image

    if image.shape[0] == size and image.shape[1] == size:
        return image
    dtype = image.dtype
    if dtype == np.uint8:
        img = Image.fromarray(image, "RGBA").resize((size, size), Image.BILINEAR)
        return np.asarray(img, dtype=np.uint8)
    # float path: resize channels individually
    chans = [
        np.asarray(
            Image.fromarray(image[..., c].astype(np.float32), "F").resize(
                (size, size), Image.BILINEAR
            )
        )
        for c in range(image.shape[2])
    ]
    return np.stack(chans, axis=-1).astype(dtype)
