"""OpenCV's uint8 RGB <-> YCrCb conversions, in NumPy.

The JAX package converts uint8 images with ``cv2.cvtColor`` and
``COLOR_RGB2YCrCb`` / ``COLOR_YCrCb2RGB`` (the datasets, ``to_image``
and ``render_frame``); the card's machine has no OpenCV. OpenCV's uint8
paths are fixed point with 14 fractional bits and round-half-up
descaling (``CV_DESCALE``), not the float formulas, so these repeat its
integer arithmetic and agree with it bit for bit.
"""

import numpy as np

__all__ = ["rgb_to_ycrcb", "ycrcb_to_rgb"]

_SHIFT = 14
_HALF = 1 << (_SHIFT - 1)
_DELTA = 128
# RGB -> YCrCb: Y weights of R, G, B, then the Cr and Cb scales
_R2Y, _G2Y, _B2Y, _CR, _CB = 4899, 9617, 1868, 11682, 9241
# YCrCb -> RGB: Cr -> R, Cr -> G, Cb -> G, Cb -> B
_CR2R, _CR2G, _CB2G, _CB2B = 22987, -11698, -5636, 29049


def _descale(x: np.ndarray) -> np.ndarray:
    """``(x + 2^13) >> 14``, an arithmetic shift (floor for negatives)."""
    return (x + _HALF) >> _SHIFT


def _as_pixels(image: np.ndarray) -> np.ndarray:
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.shape[-1] != 3:
        raise ValueError(f"expected a (..., 3) uint8 image, got "
                         f"{image.dtype} {image.shape}")
    return image.astype(np.int32)


def rgb_to_ycrcb(image: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 RGB -> uint8 YCrCb, as
    ``cv2.cvtColor(image, cv2.COLOR_RGB2YCrCb)``."""
    pixels = _as_pixels(image)
    r, g, b = pixels[..., 0], pixels[..., 1], pixels[..., 2]
    y = _descale(r * _R2Y + g * _G2Y + b * _B2Y)
    cr = _descale((r - y) * _CR + (_DELTA << _SHIFT))
    cb = _descale((b - y) * _CB + (_DELTA << _SHIFT))
    return np.clip(np.stack([y, cr, cb], -1), 0, 255).astype(np.uint8)


def ycrcb_to_rgb(image: np.ndarray) -> np.ndarray:
    """(..., 3) uint8 YCrCb -> uint8 RGB, as
    ``cv2.cvtColor(image, cv2.COLOR_YCrCb2RGB)``."""
    pixels = _as_pixels(image)
    y = pixels[..., 0]
    cr = pixels[..., 1] - _DELTA
    cb = pixels[..., 2] - _DELTA
    r = y + _descale(cr * _CR2R)
    g = y + _descale(cb * _CB2G + cr * _CR2G)
    b = y + _descale(cb * _CB2B)
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)
