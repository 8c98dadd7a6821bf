"""Image resizing for the texture stacks (the port's assets/image_io.py
without its loaders): (H, W, 4) numpy arrays, row 0 = top."""

from __future__ import annotations

import numpy as np


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
