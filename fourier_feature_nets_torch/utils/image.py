"""OpenCV's ``INTER_AREA`` resize in NumPy.

The JAX package's image regression resizes with
``cv2.resize(..., interpolation=cv2.INTER_AREA)``; the card's machine
has no OpenCV. Both axes are a matrix of weights over the source
pixels, as OpenCV's resize is separable:

* shrinking both axes (OpenCV's area mode): each output pixel averages
  the source pixels its footprint covers, each weighted by the part of
  it that lies inside (``computeResizeAreaTab``);
* otherwise (OpenCV's linear path with the area rule for the
  fraction): output ``d`` reads source ``s = floor(d * src / dst)`` and
  ``s + 1`` with the fraction ``f = (d + 1) - (s + 1) * dst / src``,
  taken mod 1 and 0 where it is not positive, so an integer enlargement
  repeats pixels.

The sums run in f64 and round to the nearest integer, where OpenCV
uses fixed-point or f32 sums: the results agree within 1.
"""

import numpy as np

__all__ = ["resize_area"]


def _area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of a shrinking axis: each source pixel's
    overlap with the output pixel's footprint, over the footprint."""
    scale = src / dst
    low = np.arange(dst, dtype=np.float64)[:, None] * scale
    pixel = np.arange(src, dtype=np.float64)[None, :]
    overlap = np.clip(np.minimum(low + scale, pixel + 1.0)
                      - np.maximum(low, pixel), 0.0, None)
    return overlap / np.minimum(scale, src - low)


def _linear_area_weights(src: int, dst: int) -> np.ndarray:
    """(dst, src) weights of the linear path with the area rule for the
    fraction, clamped at the last source pixel."""
    out = np.arange(dst)
    first = np.floor(out * (src / dst)).astype(np.int64)
    frac = ((out + 1) - (first + 1) * (dst / src)).astype(np.float32)
    frac = np.where(frac <= 0, np.float32(0.0), frac - np.floor(frac))
    frac = np.where(first >= src - 1, 0.0, frac).astype(np.float64)
    first = np.minimum(first, src - 1)
    weights = np.zeros((dst, src))
    np.add.at(weights, (out, first), 1.0 - frac)
    np.add.at(weights, (out, np.minimum(first + 1, src - 1)), frac)
    return weights


def resize_area(image: np.ndarray, width: int, height: int) -> np.ndarray:
    """``cv2.resize(image, (width, height), interpolation=cv2.INTER_AREA)``
    of an (H, W) or (H, W, C) uint8 image, within 1 of OpenCV's
    values."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or image.ndim not in (2, 3):
        raise ValueError(f"expected an (H, W[, C]) uint8 image, got "
                         f"{image.dtype} {image.shape}")
    src_h, src_w = image.shape[:2]
    if (src_h, src_w) == (height, width):
        return image.copy()
    if src_w >= width and src_h >= height:
        rows, cols = _area_weights(src_h, height), _area_weights(src_w,
                                                                  width)
    else:
        rows = _linear_area_weights(src_h, height)
        cols = _linear_area_weights(src_w, width)
    pixels = image.reshape(src_h, src_w, -1).astype(np.float64)
    out = np.einsum("yh,hwc,xw->yxc", rows, pixels, cols, optimize=True)
    out = np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.reshape((height, width) + image.shape[2:])
