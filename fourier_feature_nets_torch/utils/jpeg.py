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

__all__ = ["decode_jpeg", "encode_jpeg"]

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


# ---------------------------------------------------------------------------
# the baseline decoder
# ---------------------------------------------------------------------------

_SOF_KINDS = {
    0xC1: None, 0xC2: "progressive", 0xC3: "lossless",
    0xC5: "differential sequential", 0xC6: "differential progressive",
    0xC7: "differential lossless", 0xC9: "arithmetic-coded sequential",
    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}

# libjpeg's ISLOW IDCT constants (jidctint.c): FIX(x) at 13 bits
_CONST_BITS, _PASS1_BITS = 13, 2
(_F0298, _F0390, _F0541, _F0765, _F0899, _F1175, _F1501, _F1847, _F1961,
 _F2053, _F2562, _F3072) = (2446, 3196, 4433, 6270, 7373, 9633, 12299, 15137,
                           16069, 16819, 20995, 25172)


def _descale(x: np.ndarray, bits: int) -> np.ndarray:
    return (x + (1 << (bits - 1))) >> bits


def _idct_1d(s, shift: int):
    """One pass of libjpeg's ISLOW IDCT over ``s``, the 8 inputs as
    int64 arrays; returns the 8 outputs descaled by ``shift`` bits."""
    z1 = (s[2] + s[6]) * _F0541
    tmp2 = z1 - s[6] * _F1847
    tmp3 = z1 + s[2] * _F0765
    tmp0 = (s[0] + s[4]) << _CONST_BITS
    tmp1 = (s[0] - s[4]) << _CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = s[7], s[5], s[3], s[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _F1175
    t0, t1, t2, t3 = t0 * _F0298, t1 * _F2053, t2 * _F3072, t3 * _F1501
    z1, z2 = z1 * -_F0899, z2 * -_F2562
    z3, z4 = z3 * -_F1961 + z5, z4 * -_F0390 + z5
    t0 = t0 + z1 + z3
    t1 = t1 + z2 + z4
    t2 = t2 + z2 + z3
    t3 = t3 + z1 + z4
    return [_descale(v, shift) for v in (
        tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
        tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_islow(coefs: np.ndarray) -> np.ndarray:
    """(N, 8, 8) dequantized coefficients (natural order, int64) -> (N,
    8, 8) uint8 samples, as libjpeg's ``jpeg_idct_islow``: columns then
    rows in integer arithmetic, the result shifted by 128 and
    clamped."""
    columns = _idct_1d([coefs[:, k, :] for k in range(8)],
                       _CONST_BITS - _PASS1_BITS)
    work = np.stack(columns, axis=1)        # (N, row, col)
    rows = _idct_1d([work[:, :, k] for k in range(8)],
                    _CONST_BITS + _PASS1_BITS + 3)
    out = np.stack(rows, axis=2)
    return np.clip(out + 128, 0, 255).astype(np.uint8)


def _upsample_h2(plane: np.ndarray) -> np.ndarray:
    """libjpeg's fancy (triangle) h2v1 upsampling of an (H, W) int
    plane: each output pixel 3/4 its own sample and 1/4 the nearer
    neighbour's, with its alternating rounding; the edge pixels copy
    their sample."""
    out = np.empty((plane.shape[0], plane.shape[1] * 2), np.int64)
    left = np.concatenate([plane[:, :1], plane[:, :-1]], axis=1)
    right = np.concatenate([plane[:, 1:], plane[:, -1:]], axis=1)
    out[:, 0::2] = (plane * 3 + left + 1) >> 2
    out[:, 1::2] = (plane * 3 + right + 2) >> 2
    out[:, 0] = plane[:, 0]
    out[:, -1] = plane[:, -1]
    return out


def _upsample_h2v2(plane: np.ndarray) -> np.ndarray:
    """libjpeg's fancy h2v2 upsampling: each output row's column sums
    3 * its row + the nearer neighbour row (the edge rows repeat), then
    the h2v1 triangle over those sums at 4 bits, rounding by 8 and 7."""
    above = np.concatenate([plane[:1], plane[:-1]], axis=0)
    below = np.concatenate([plane[1:], plane[-1:]], axis=0)
    sums = np.empty((plane.shape[0] * 2, plane.shape[1]), np.int64)
    sums[0::2] = plane * 3 + above
    sums[1::2] = plane * 3 + below
    left = np.concatenate([sums[:, :1], sums[:, :-1]], axis=1)
    right = np.concatenate([sums[:, 1:], sums[:, -1:]], axis=1)
    out = np.empty((sums.shape[0], sums.shape[1] * 2), np.int64)
    out[:, 0::2] = (sums * 3 + left + 8) >> 4
    out[:, 1::2] = (sums * 3 + right + 7) >> 4
    out[:, 0] = (sums[:, 0] * 4 + 8) >> 4
    out[:, -1] = (sums[:, -1] * 4 + 7) >> 4
    return out


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, 16 bits)."""
    def fix(x):
        return int(x * 65536 + 0.5)
    half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb - fix(0.71414) * cr + half) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _lookup(spec):
    """A 16-bit lookup table of a Huffman table given as (counts by
    length, symbols): entry = length | symbol << 8 (0 for no code)."""
    counts, symbols = spec
    table = [0] * 65536
    code, k = 0, 0
    for length, count in enumerate(counts, start=1):
        for _ in range(count):
            start = code << (16 - length)
            table[start:start + (1 << (16 - length))] = (
                [length | symbols[k] << 8] * (1 << (16 - length)))
            code += 1
            k += 1
        code <<= 1
    return table


def _orientation(payload: bytes) -> int:
    """The EXIF orientation (tag 0x0112) of an APP1 payload, or 1."""
    if not payload.startswith(b"Exif\x00\x00") or len(payload) < 14:
        return 1
    tiff = payload[6:]
    order = {b"II": "<", b"MM": ">"}.get(tiff[:2])
    if order is None:
        return 1
    (offset,) = struct.unpack_from(order + "I", tiff, 4)
    if offset + 2 > len(tiff):
        return 1
    (count,) = struct.unpack_from(order + "H", tiff, offset)
    for i in range(count):
        entry = offset + 2 + 12 * i
        if entry + 12 > len(tiff):
            break
        tag, kind = struct.unpack_from(order + "HH", tiff, entry)
        if tag == 0x0112 and kind == 3:
            (value,) = struct.unpack_from(order + "H", tiff, entry + 8)
            return value if 1 <= value <= 8 else 1
    return 1


def _orient(image: np.ndarray, orientation: int) -> np.ndarray:
    """The image turned upright by its EXIF orientation, as OpenCV's
    ``imread`` does (its ``ExifTransform``)."""
    if orientation >= 5:
        image = image.transpose(1, 0, 2)
    flips = {2: (1,), 3: (0, 1), 4: (0,), 6: (1,), 7: (0, 1), 8: (0,)}
    for axis in flips.get(orientation, ()):
        image = np.flip(image, axis)
    return np.ascontiguousarray(image)


def _entropy_decode(data: bytes, units, num_components: int,
                    blocks_total: int, mcus_per_interval: int,
                    num_mcus: int) -> np.ndarray:
    """The quantized coefficients of a scan: (blocks_total, 64) int32 in
    zigzag order. ``units`` lists each MCU's blocks as (component,
    block index function of the MCU, DC table, AC table); the scan's
    entropy-coded data is split at its restart markers, each interval
    starting at a byte boundary with its DC predictions at 0."""
    # intervals between RSTn markers, then the 0xFF00 stuffing removed
    intervals, start, pos = [], 0, 0
    while True:
        pos = data.find(b"\xff", pos)
        if pos < 0 or pos + 1 >= len(data):
            intervals.append(data[start:])
            break
        marker = data[pos + 1]
        if marker == 0x00 or marker == 0xFF:
            pos += 1 if marker == 0xFF else 2
            continue
        intervals.append(data[start:pos])
        if 0xD0 <= marker <= 0xD7:
            start = pos = pos + 2
            continue
        break
    out = np.zeros((blocks_total, 64), np.int32)
    flat_index, flat_value = [], []
    mcu = 0
    for chunk in intervals:
        if mcu >= num_mcus:
            break
        chunk = chunk.replace(b"\xff\x00", b"\xff") + b"\x00" * 8
        # 48 bits from each byte: a 32-bit window at any bit position
        raw = np.frombuffer(chunk, np.uint8).astype(np.uint64)
        words = np.zeros(len(chunk) - 5, np.uint64)
        for k in range(6):
            words = (words << np.uint64(8)) | raw[k:k + len(words)]
        words = words.tolist()
        bit = 0
        preds = [0] * num_components
        for _ in range(min(mcus_per_interval, num_mcus - mcu)):
            for comp, block_of, dc, ac in units:
                base = block_of(mcu) * 64
                window = (words[bit >> 3] >> (16 - (bit & 7))) & 0xFFFFFFFF
                entry = dc[window >> 16]
                if not entry:
                    raise ValueError("corrupt JPEG: bad Huffman code")
                bit += entry & 0xFF
                size = entry >> 8
                if size:
                    window = ((words[bit >> 3] >> (16 - (bit & 7)))
                              & 0xFFFFFFFF)
                    value = window >> (32 - size)
                    if value < 1 << (size - 1):
                        value -= (1 << size) - 1
                    bit += size
                    preds[comp] += value
                flat_index.append(base)
                flat_value.append(preds[comp])
                k = 1
                while k < 64:
                    window = ((words[bit >> 3] >> (16 - (bit & 7)))
                              & 0xFFFFFFFF)
                    entry = ac[window >> 16]
                    if not entry:
                        raise ValueError("corrupt JPEG: bad Huffman code")
                    bit += entry & 0xFF
                    run, size = entry >> 12, (entry >> 8) & 0xF
                    if not size:
                        if run != 15:
                            break
                        k += 16
                        continue
                    k += run
                    window = ((words[bit >> 3] >> (16 - (bit & 7)))
                              & 0xFFFFFFFF)
                    value = window >> (32 - size)
                    if value < 1 << (size - 1):
                        value -= (1 << size) - 1
                    bit += size
                    flat_index.append(base + k)
                    flat_value.append(value)
                    k += 1
            mcu += 1
    if mcu < num_mcus:
        raise ValueError(f"truncated JPEG: {mcu} of {num_mcus} MCUs")
    out.reshape(-1)[np.asarray(flat_index, np.int64)] = flat_value
    return out


def decode_jpeg(data: bytes) -> np.ndarray:
    """An (H, W, 3) uint8 RGB image of a baseline JPEG file, as
    ``cv2.imread(path, cv2.IMREAD_COLOR)`` (BGR -> RGB) reads it, within
    1 of its values: sequential Huffman, 8-bit, 1 or 3 components (a grey
    image becomes 3 equal channels), sampling 1x1, 2x1 or 2x2 against
    the chroma, restart intervals; libjpeg's ISLOW integer IDCT, its
    fancy (triangle) upsampling and fixed-point YCbCr -> RGB, and the
    EXIF orientation. Progressive, arithmetic-coded, lossless,
    hierarchical, 12-bit and 4-component (CMYK) files raise
    ``ValueError`` naming what they are."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI marker)")
    qtables, huffman = {}, {}
    frame = None
    orientation = 1
    restart = 0
    adobe_transform = None
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and (
                pos + 1 < len(data) and data[pos + 1] == 0xFF):
            pos += 1
        if pos + 4 > len(data) or data[pos] != 0xFF:
            raise ValueError("corrupt JPEG: no scan")
        marker = data[pos + 1]
        (length,) = struct.unpack_from(">H", data, pos + 2)
        payload = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker == 0xDB:
            at = 0
            while at < len(payload):
                precision, ident = payload[at] >> 4, payload[at] & 0xF
                if precision:
                    raise ValueError("16-bit quantization tables (a "
                                     "12-bit JPEG) are not supported")
                qtables[ident] = np.frombuffer(payload, np.uint8, 64,
                                               at + 1).astype(np.int64)
                at += 65
        elif marker == 0xC4:
            at = 0
            while at < len(payload):
                kind, ident = payload[at] >> 4, payload[at] & 0xF
                counts = list(payload[at + 1:at + 17])
                symbols = list(payload[at + 17:at + 17 + sum(counts)])
                huffman[kind, ident] = _lookup((counts, symbols))
                at += 17 + sum(counts)
        elif marker == 0xC0 or marker in _SOF_KINDS:
            kind = _SOF_KINDS.get(marker)
            if kind is not None:
                raise ValueError(f"{kind} JPEG is not supported (baseline "
                                 "sequential only)")
            precision, height, width, count = struct.unpack_from(
                ">BHHB", payload)
            if precision != 8:
                raise ValueError(f"{precision}-bit JPEG is not supported")
            if count not in (1, 3):
                raise ValueError(f"{count}-component JPEG (CMYK or other) "
                                 "is not supported")
            comps = [(payload[6 + 3 * i], payload[7 + 3 * i] >> 4,
                      payload[7 + 3 * i] & 0xF, payload[8 + 3 * i])
                     for i in range(count)]
            frame = (height, width, comps)
        elif marker == 0xCC:
            raise ValueError("arithmetic-coded JPEG is not supported")
        elif marker == 0xDD:
            (restart,) = struct.unpack_from(">H", payload)
        elif marker == 0xE1 and orientation == 1:
            orientation = _orientation(payload)
        elif marker == 0xEE and payload.startswith(b"Adobe") and len(
                payload) >= 12:
            adobe_transform = payload[11]
        elif marker == 0xDA:
            break
        elif marker == 0xD9:
            raise ValueError("corrupt JPEG: no scan")
    if frame is None:
        raise ValueError("corrupt JPEG: no frame header")
    height, width, comps = frame
    if height == 0:
        raise ValueError("JPEG with a DNL height is not supported")
    count = payload[0]
    if count != len(comps):
        raise ValueError("multi-scan sequential JPEG is not supported")
    selectors = {payload[1 + 2 * i]: (payload[2 + 2 * i] >> 4,
                                      payload[2 + 2 * i] & 0xF)
                 for i in range(count)}
    if len(comps) == 3 and adobe_transform == 0:
        raise ValueError("RGB-coded JPEG (Adobe transform 0) is not "
                         "supported")
    hmax = max(c[1] for c in comps)
    vmax = max(c[2] for c in comps)
    for _, h, v, _ in comps:
        if (hmax // h, vmax // v) not in ((1, 1), (2, 1), (2, 2)) or (
                hmax % h or vmax % v):
            raise ValueError(f"JPEG sampling {hmax // h}x{vmax // v} is not "
                             "supported (1x1, 2x1 or 2x2 only)")

    # the MCU layout: one block per MCU for a single component, else
    # h x v blocks of each component in order
    if len(comps) == 1:
        mcu_cols, mcu_rows = -(-width // 8), -(-height // 8)
    else:
        mcu_cols = -(-width // (8 * hmax))
        mcu_rows = -(-height // (8 * vmax))
    units, offsets, shapes = [], [], []
    total = 0
    for index, (ident, h, v, _) in enumerate(comps):
        if len(comps) == 1:
            h = v = 1
        cols, rows = mcu_cols * h, mcu_rows * v
        offsets.append(total)
        shapes.append((rows, cols))
        dc_id, ac_id = selectors[ident]
        for by in range(v):
            for bx in range(h):
                def block_of(mcu, by=by, bx=bx, h=h, v=v, cols=cols,
                             base=total):
                    row, col = divmod(mcu, mcu_cols)
                    return base + (row * v + by) * cols + col * h + bx
                units.append((index, block_of, huffman[0, dc_id],
                              huffman[1, ac_id]))
        total += rows * cols
    num_mcus = mcu_cols * mcu_rows
    coefs = _entropy_decode(data[pos:], units, len(comps), total,
                            restart or num_mcus, num_mcus)

    planes = []
    for index, (_, h, v, qid) in enumerate(comps):
        rows, cols = shapes[index]
        block = coefs[offsets[index]:offsets[index] + rows * cols]
        natural = np.zeros_like(block, np.int64)
        natural[:, ZIGZAG] = block * qtables[qid][None, :]
        pixels = _idct_islow(natural.reshape(-1, 8, 8)).reshape(
            rows, cols, 8, 8).transpose(0, 2, 1, 3).reshape(
                rows * 8, cols * 8).astype(np.int64)
        if len(comps) == 1:
            planes.append(pixels[:height, :width])
            continue
        # the component's own size, then upsampled to the image's
        comp_h = -(-height * v // vmax)
        comp_w = -(-width * h // hmax)
        pixels = pixels[:comp_h, :comp_w]
        if (hmax // h, vmax // v) == (2, 1):
            pixels = _upsample_h2(pixels)
        elif (hmax // h, vmax // v) == (2, 2):
            pixels = _upsample_h2v2(pixels)
        planes.append(pixels[:height, :width])
    if len(planes) == 1:
        image = np.repeat(planes[0].astype(np.uint8)[..., None], 3, axis=2)
    else:
        image = _ycc_to_rgb(*planes)
    return _orient(image, orientation)
