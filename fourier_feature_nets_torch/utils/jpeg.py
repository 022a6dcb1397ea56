"""A baseline JPEG encoder in NumPy.

The JAX package's render server encodes its JPEG frames with
``cv2.imencode`` (``render/server.py``); the port's card machine has no
OpenCV, so the port encodes them itself, with OpenCV's defaults: quality
95 (the IJG scaling of the Annex K quantization tables), 4:2:0 chroma,
the standard Huffman tables of Annex K.3 and a JFIF header. The colour
transform is JFIF's; the image is padded to whole 16x16 MCUs by
repeating its last row and column, as libjpeg does; each 8x8 block's DCT
is one matrix product over all blocks; the entropy coder works on whole
arrays: run lengths, categories, the Huffman codes and the bit packing
(with the 0xFF byte stuffing) are NumPy operations, with no Python loop
per coefficient.

    data = encode_jpeg(rgb_uint8_image)        # bytes of a .jpg file
"""

import struct

import numpy as np

__all__ = ["encode_jpeg"]

# Annex K.1: the luminance and chrominance quantization tables, in
# natural (row-major) order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *[99] * 32])

# the zigzag scan: ZIGZAG[i] is the natural index of the i-th coefficient
ZIGZAG = np.array(sorted(range(64), key=lambda n: (
    n // 8 + n % 8,
    (n // 8) if (n // 8 + n % 8) % 2 else (n % 8))))

# Annex K.3: (code counts by length 1..16, symbols) of the DC and AC
# tables of luminance and chrominance
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
              bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))


def _dct_matrix() -> np.ndarray:
    """The orthonormal 8-point DCT-II, whose 2-D form is JPEG's FDCT."""
    n = np.arange(8)
    m = np.cos((2 * n[None, :] + 1) * n[:, None] * np.pi / 16) * 0.5
    m[0] /= np.sqrt(2.0)
    return m


# one block's 2-D DCT as a (64, 64) matrix on the flattened block, its
# outputs in zigzag order
_DCT2_ZIGZAG = np.kron(_dct_matrix(), _dct_matrix())[ZIGZAG].T.astype(
    np.float32)


def quant_tables(quality: int):
    """The luminance and chrominance tables at ``quality`` (IJG
    scaling, clamped to 1..255 for a baseline file), natural order."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return tuple(np.clip((base * scale + 50) // 100, 1, 255)
                 for base in (_LUMA_Q, _CHROMA_Q))


def _huffman(spec):
    """(code, length) lookup arrays over 256 symbols of a table given as
    (counts by length, symbols): the canonical codes of Annex C."""
    counts, symbols = spec
    code_of = np.zeros(256, np.uint64)
    length_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            code_of[symbols[k]] = code
            length_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, length_of


_TABLES = {name: _huffman(spec) for name, spec in (
    ("dc0", _DC_LUMA), ("ac0", _AC_LUMA), ("dc1", _DC_CHROMA),
    ("ac1", _AC_CHROMA))}


def _ycbcr(rgb: np.ndarray):
    """JFIF's RGB -> YCbCr of an (H, W, 3) uint8 image in libjpeg's
    16-bit fixed point: three (H, W) f32 planes, level-shifted by
    -128."""
    r, g, b = (rgb[..., c].astype(np.int32) for c in range(3))
    half, center = 1 << 15, (128 << 16) + (1 << 15) - 1
    y = (19595 * r + 38470 * g + 7471 * b + half) >> 16
    cb = (-11059 * r - 21709 * g + 32768 * b + center) >> 16
    cr = (32768 * r - 27439 * g - 5329 * b + center) >> 16
    return [(p - 128).astype(np.float32) for p in (y, cb, cr)]


def _blocks(plane: np.ndarray) -> np.ndarray:
    """(8R, 8C) plane -> (R, C, 64) blocks, each row-major."""
    rows, cols = plane.shape[0] // 8, plane.shape[1] // 8
    return plane.reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3).reshape(
        rows, cols, 64)


def _category(values: np.ndarray) -> np.ndarray:
    """The bit length of |v| (0 for 0): the JPEG magnitude category."""
    return np.frexp(np.abs(values).astype(np.float64))[1].astype(np.int64)


def _bits(values: np.ndarray, size: np.ndarray) -> np.ndarray:
    """The ``size`` low bits JPEG appends for each value: v itself, or
    v - 1 in two's complement (the ones' complement of |v|) below 0."""
    values = values.astype(np.int64)
    return np.where(values < 0, values + (1 << size) - 1,
                    values).astype(np.uint64)


def _entropy(coefs: np.ndarray, chroma: np.ndarray) -> bytes:
    """The entropy-coded segment of (B, 64) zigzag-ordered quantized
    blocks in coding order, ``chroma`` (B,) marking Cb/Cr blocks; the
    DC predictions run per component, whose ids follow the 4:2:0 MCU
    (Y Y Y Y Cb Cr)."""
    num = coefs.shape[0]
    component = np.tile(np.array([0, 0, 0, 0, 1, 2]), num // 6)
    dc = coefs[:, 0].astype(np.int64)
    diff = np.empty_like(dc)
    for comp in range(3):
        rows = np.nonzero(component == comp)[0]
        diff[rows] = np.diff(dc[rows], prepend=0)

    def table(kind, symbols, which):
        code = np.where(which, _TABLES[kind + "1"][0][symbols],
                        _TABLES[kind + "0"][0][symbols])
        length = np.where(which, _TABLES[kind + "1"][1][symbols],
                          _TABLES[kind + "0"][1][symbols])
        return code, length

    # DC: the category's code, then its bits
    size = _category(diff)
    code, length = table("dc", size, chroma)
    items = [(np.arange(num) * 65, (code << size.astype(np.uint64))
              | _bits(diff, size), length + size)]

    # AC: each non-zero coefficient is (ZRL x (run // 16)) then the code
    # of (run % 16, category), then its bits
    flat = np.flatnonzero(coefs)
    flat = flat[flat % 64 != 0]
    block, pos = flat // 64, flat % 64
    value = coefs.reshape(-1)[flat].astype(np.int64)
    first = np.ones(block.shape[0], bool)
    first[1:] = block[1:] != block[:-1]
    prev = np.where(first, 0, np.roll(pos, 1))
    run = pos - prev - 1
    zrl = run // 16
    size = _category(value)
    which = chroma[block]
    code, length = table("ac", (run % 16) * 16 + size, which)
    zrl_code, zrl_len = table("ac", np.full_like(run, 0xF0), which)
    # at most 3 ZRLs (run <= 62): unrolled as shifts of one 64-bit word
    word = np.zeros(block.shape[0], np.uint64)
    for k in range(3):
        more = zrl > k
        word = np.where(more, (word << zrl_len.astype(np.uint64)) | zrl_code,
                        word)
    word = (((word << length.astype(np.uint64)) | code)
            << size.astype(np.uint64)) | _bits(value, size)
    items.append((block * 65 + pos, word,
                  zrl * zrl_len + length + size))

    # EOB after a block whose last coefficient is zero
    eob = np.nonzero(coefs[:, 63] == 0)[0]
    code, length = table("ac", np.zeros_like(eob), chroma[eob])
    items.append((eob * 65 + 64, code, length))

    keys = np.concatenate([k for k, _, _ in items])
    order = np.argsort(keys, kind="stable")
    words = np.concatenate([w for _, w, _ in items])[order]
    lengths = np.concatenate([n for _, _, n in items])[order]

    # pack: every bit of every word, most significant first, then 1s to
    # the byte boundary; then a 0x00 after each 0xFF byte
    ends = np.cumsum(lengths)
    total = int(ends[-1])
    owner = np.repeat(np.arange(words.shape[0]), lengths)
    shift = (ends[owner] - 1 - np.arange(total)).astype(np.uint64)
    bits = ((words[owner] >> shift) & np.uint64(1)).astype(np.uint8)
    bits = np.concatenate([bits, np.ones(-total % 8, np.uint8)])
    data = np.packbits(bits)
    stuff = np.nonzero(data == 0xFF)[0]
    return np.insert(data, stuff + 1, 0).tobytes()


def _segment(marker: int, payload: bytes) -> bytes:
    return struct.pack(">HH", marker, len(payload) + 2) + payload


def _dht(table_class: int, table_id: int, spec) -> bytes:
    counts, symbols = spec
    return bytes([table_class << 4 | table_id, *counts, *symbols])


def encode_jpeg(image: np.ndarray, quality: int = 95) -> bytes:
    """A baseline JFIF JPEG of an (H, W, 3) uint8 RGB image at
    ``quality`` (OpenCV's default 95), 4:2:0 chroma, the standard
    Huffman tables."""
    image = np.asarray(image)
    if image.ndim != 3 or image.shape[2] != 3 or image.dtype != np.uint8:
        raise ValueError(f"expected an (H, W, 3) uint8 image, got "
                         f"{image.shape} {image.dtype}")
    height, width = image.shape[:2]
    if not 0 < height < 65536 or not 0 < width < 65536:
        raise ValueError(f"no baseline JPEG of {width}x{height}")
    pad_h, pad_w = -height % 16, -width % 16
    padded = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), mode="edge")
    y, cb, cr = _ycbcr(padded)
    rows, cols = padded.shape[0] // 16, padded.shape[1] // 16
    # 4:2:0: each chroma sample the mean of a 2x2 square
    cb, cr = ((p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2]
               + p[1::2, 1::2]) * 0.25 for p in (cb, cr))

    luma_q, chroma_q = quant_tables(quality)
    # (rows, cols, 4, 64): the four Y blocks of each MCU in order
    y = _blocks(y).reshape(rows, 2, cols, 2, 64).transpose(
        0, 2, 1, 3, 4).reshape(rows, cols, 4, 64)
    blocks = np.concatenate([y, _blocks(cb)[:, :, None],
                             _blocks(cr)[:, :, None]], axis=2).reshape(-1, 64)
    scale = 1.0 / np.stack([luma_q[ZIGZAG]] * 4 + [chroma_q[ZIGZAG]] * 2)
    coefs = (blocks @ _DCT2_ZIGZAG).reshape(rows * cols, 6, 64)
    coefs *= scale.astype(np.float32)
    q = np.rint(coefs).astype(np.int32).reshape(-1, 64)
    is_chroma = np.tile(np.array([False] * 4 + [True] * 2), rows * cols)

    header = b"\xff\xd8" + _segment(
        0xFFE0, b"JFIF\x00" + struct.pack(">BBBHHBB", 1, 1, 0, 1, 1, 0, 0))
    header += _segment(0xFFDB, bytes([0, *luma_q[ZIGZAG]])
                       + bytes([1, *chroma_q[ZIGZAG]]))
    header += _segment(0xFFC0, struct.pack(">BHHB", 8, height, width, 3)
                       + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1]))
    header += _segment(0xFFC4, _dht(0, 0, _DC_LUMA) + _dht(1, 0, _AC_LUMA)
                       + _dht(0, 1, _DC_CHROMA) + _dht(1, 1, _AC_CHROMA))
    header += _segment(0xFFDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return header + _entropy(q, is_chroma) + b"\xff\xd9"
