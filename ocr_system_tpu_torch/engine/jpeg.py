"""A first-party baseline JPEG encoder in numpy (the JAX package encodes
with PIL, which the card machine's environment does not promise).

It writes what PIL's ``Image.save(format="JPEG", quality=q)`` writes with
libjpeg(-turbo)'s defaults: a JFIF 1.01 header, the Annex K quantisation
tables scaled by IJG quality, the Annex K Huffman tables, and one
baseline sequential scan; RGB pixels are converted to YCbCr with libjpeg's
16-bit fixed-point table arithmetic and their chroma subsampled 4:2:0
(``h2v2_downsample``: 2 x 2 means with the alternating 1, 2 bias), gray
pixels go out as one component. Each 8 x 8 block goes through libjpeg's
integer ("islow") forward DCT and its rounding quantizer, with its edge
padding (replicated samples) and dummy blocks (zero AC, the neighbour's
DC) where the image does not fill the last MCU. Every step is vectorised
over all blocks; the entropy coder builds every code word at once and
packs them into bytes with one ``bincount``.
"""

from __future__ import annotations

import numpy as np

# Annex K.1 quantisation tables, natural (row-major) order
_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99,
], np.int64)
_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    *([99] * 32),
], np.int64)

# zigzag position k -> natural index (libjpeg's jpeg_natural_order)
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])

# Annex K.3 Huffman tables: (code counts per length 1..16, symbols)
_DC_LUMA = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), tuple(range(12)))
_DC_CHROMA = ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), tuple(range(12)))
_AC_LUMA = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa"))
_AC_CHROMA = ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa"))

_CONST_BITS, _PASS1_BITS = 13, 2
_FIX16 = lambda x: int(x * 65536 + 0.5)  # noqa: E731  (libjpeg FIX, SCALEBITS 16)


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """IJG quality scaling of a base table (``jpeg_set_quality`` with
    ``force_baseline``): entries in [1, 255]."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _huffman_codes(spec) -> tuple[np.ndarray, np.ndarray]:
    """Code word and length per symbol (0..255) of an Annex K table."""
    counts, symbols = spec
    code_of = np.zeros(256, np.int64)
    len_of = np.zeros(256, np.int64)
    code, k = 0, 0
    for length, n in enumerate(counts, 1):
        for _ in range(n):
            code_of[symbols[k]] = code
            len_of[symbols[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, len_of


_TABLES = {spec: _huffman_codes(spec) for spec in (_DC_LUMA, _DC_CHROMA, _AC_LUMA, _AC_CHROMA)}


def rgb_to_ycc(rgb: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """libjpeg's ``rgb_ycc_convert``: 16-bit fixed point, rounded by the
    tables' offsets."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_FIX16(0.29900) * r + _FIX16(0.58700) * g + _FIX16(0.11400) * b + half) >> 16
    cb = (-_FIX16(0.16874) * r - _FIX16(0.33126) * g + _FIX16(0.5) * b
          + offset + half - 1) >> 16
    cr = (_FIX16(0.5) * r - _FIX16(0.41869) * g - _FIX16(0.08131) * b
          + offset + half - 1) >> 16
    return y, cb, cr


def _pad_edges(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """The plane grown to (rows, cols) by replicating its last row and
    column (libjpeg's expand_right_edge and expand_bottom_edge)."""
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def _downsample_h2v2(plane: np.ndarray, out_rows: int, out_cols: int) -> np.ndarray:
    """libjpeg's ``h2v2_downsample`` of a full-resolution chroma plane: the
    input padded to (2 * ceil(h / 2), 2 * out_cols), each 2 x 2 summed with
    a bias alternating 1, 2 along the row and shifted by 2; then the output
    padded to out_rows by replicating its last row."""
    h, _ = plane.shape
    p = _pad_edges(plane, h + (h & 1), 2 * out_cols)
    s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    return _pad_edges((s + bias) >> 2, out_rows, out_cols)


def _fdct_pass(x: np.ndarray, first: bool) -> np.ndarray:
    """One pass of ``jpeg_fdct_islow`` along axis 0 (8 samples)."""
    tmp0, tmp7 = x[0] + x[7], x[0] - x[7]
    tmp1, tmp6 = x[1] + x[6], x[1] - x[6]
    tmp2, tmp5 = x[2] + x[5], x[2] - x[5]
    tmp3, tmp4 = x[3] + x[4], x[3] - x[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = np.empty_like(x)
    if first:
        out[0] = (tmp10 + tmp11) << _PASS1_BITS
        out[4] = (tmp10 - tmp11) << _PASS1_BITS
        n = _CONST_BITS - _PASS1_BITS
    else:
        out[0] = _descale(tmp10 + tmp11, _PASS1_BITS)
        out[4] = _descale(tmp10 - tmp11, _PASS1_BITS)
        n = _CONST_BITS + _PASS1_BITS
    z1 = (tmp12 + tmp13) * 4433  # FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * 6270, n)  # FIX_0_765366865
    out[6] = _descale(z1 - tmp12 * 15137, n)  # FIX_1_847759065
    z1, z2 = tmp4 + tmp7, tmp5 + tmp6
    z3, z4 = tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * 9633  # FIX_1_175875602
    tmp4, tmp5 = tmp4 * 2446, tmp5 * 16819  # FIX_0_298631336, FIX_2_053119869
    tmp6, tmp7 = tmp6 * 25172, tmp7 * 12299  # FIX_3_072711026, FIX_1_501321110
    z1, z2 = z1 * -7373, z2 * -20995  # FIX_0_899976223, FIX_2_562915447
    z3, z4 = z3 * -16069 + z5, z4 * -3196 + z5  # FIX_1_961570560, FIX_0_390180644
    out[7] = _descale(tmp4 + z1 + z3, n)
    out[5] = _descale(tmp5 + z2 + z4, n)
    out[3] = _descale(tmp6 + z2 + z3, n)
    out[1] = _descale(tmp7 + z1 + z4, n)
    return out


def _descale(x: np.ndarray, n: int) -> np.ndarray:
    return (x + (1 << (n - 1))) >> n


def quantized_blocks(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """A padded plane (multiples of 8 on both sides) as its blocks'
    quantized DCT coefficients, (rows, cols, 64) in zigzag order: the
    samples centred on 128, ``jpeg_fdct_islow`` (rows, then columns), and
    libjpeg's quantizer, round half away from zero of coef / (8 q)."""
    h, w = plane.shape
    blocks = (plane.astype(np.int64) - 128).reshape(h // 8, 8, w // 8, 8).transpose(1, 3, 0, 2)
    # (row in block, column in block, block row, block column)
    coef = _fdct_pass(_fdct_pass(blocks.swapaxes(0, 1), True).swapaxes(0, 1), False)
    coef = coef.reshape(64, h // 8, w // 8).transpose(1, 2, 0)[..., ZIGZAG]
    div = (qtable * 8)[ZIGZAG]
    mag = (np.abs(coef) + (div >> 1)) // div
    return np.where(coef < 0, -mag, mag)


def _with_dummies(blocks: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """A component's blocks grown to (rows, cols) MCU-aligned blocks with
    libjpeg's dummy blocks: zero AC; at the right edge the DC of the block
    to the left, in a bottom row the DC of the MCU's block above right."""
    hb, wb, _ = blocks.shape
    out = np.zeros((rows, cols, 64), np.int64)
    out[:hb, :wb] = blocks
    for c in range(wb, cols):
        out[:hb, c, 0] = out[:hb, c - 1, 0]
    for r in range(hb, rows):
        above_right = out[r - 1, 1::2, 0]
        out[r, 0::2, 0] = above_right
        out[r, 1::2, 0] = above_right
    return out


def _scan_symbols(coef: np.ndarray, comp: np.ndarray, dc_tables, ac_tables):
    """The entropy-coded items of a scan: coefficient blocks (B, 64) in scan
    order and each block's component; returns (code words, bit lengths) in
    stream order, each word a Huffman code followed by its value bits."""
    nblocks = len(coef)
    dc = coef[:, 0]
    diff = np.empty_like(dc)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        diff[idx] = np.diff(dc[idx], prepend=0)

    def value_bits(v):
        mag = np.abs(v)
        nbits = np.zeros_like(mag)
        nz = mag > 0
        nbits[nz] = np.floor(np.log2(mag[nz])).astype(np.int64) + 1
        return nbits, np.where(v < 0, v + (1 << nbits) - 1, v)

    def lookup(tables, which, symbol):
        code = np.empty_like(symbol)
        length = np.empty_like(symbol)
        for t, (codes, lens) in enumerate(tables):
            sel = which == t
            code[sel] = codes[symbol[sel]]
            length[sel] = lens[symbol[sel]]
        return code, length

    keys, words, lens = [], [], []

    # DC: category code, then the difference's bits
    cat, bits = value_bits(diff)
    code, length = lookup(dc_tables, comp, cat)
    keys.append(np.arange(nblocks) * 260)
    words.append((code << cat) | bits)
    lens.append(length + cat)

    # AC: (run, size) codes with ZRL runs of 16, EOB after the last nonzero
    bi, k = np.nonzero(coef[:, 1:])
    pos = k + 1
    first = np.ones(len(bi), bool)
    first[1:] = bi[1:] != bi[:-1]
    prev = np.where(first, 0, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    cat, bits = value_bits(coef[bi, pos])
    code, length = lookup(ac_tables, comp[bi], ((run % 16) << 4) | cat)
    keys.append(bi * 260 + pos * 4 + 3)
    words.append((code << cat) | bits)
    lens.append(length + cat)
    for j in range(3):  # a run of up to 62 zeros: at most 3 ZRLs
        sel = run // 16 > j
        zrl, zlen = lookup(ac_tables, comp[bi[sel]], np.full(int(sel.sum()), 0xF0))
        keys.append(bi[sel] * 260 + pos[sel] * 4 + j)
        words.append(zrl)
        lens.append(zlen)
    last = np.zeros(nblocks, np.int64)
    last[bi] = pos  # nonzero order is ascending within a block
    eob = np.flatnonzero(last < 63)
    code, length = lookup(ac_tables, comp[eob], np.zeros(len(eob), np.int64))
    keys.append(eob * 260 + 256)
    words.append(code)
    lens.append(length)

    order = np.argsort(np.concatenate(keys), kind="stable")
    return np.concatenate(words)[order], np.concatenate(lens)[order]


def pack_bits(words: np.ndarray, lens: np.ndarray) -> bytes:
    """Code words (each at most 32 bits) packed MSB first, the last byte
    filled with 1 bits, 0xFF bytes stuffed with 0x00."""
    ends = np.cumsum(lens)
    total = int(ends[-1]) if len(ends) else 0
    starts = ends - lens
    nbytes = (total + 7) // 8
    # each word lands in the 5 bytes from its first: its bits left-aligned
    # in a 40-bit window; words never share a bit, so a byte's sum is its OR
    window = words.astype(np.uint64) << (40 - (starts & 7) - lens).astype(np.uint64)
    first = starts >> 3
    out = np.zeros(nbytes + 5, np.float64)
    for b in range(5):
        part = ((window >> np.uint64(8 * (4 - b))) & np.uint64(0xFF)).astype(np.float64)
        out += np.bincount(first + b, weights=part, minlength=nbytes + 5)
    data = out[:nbytes].astype(np.uint8)
    if total % 8:
        data[-1] |= (1 << (8 - total % 8)) - 1
    return data.tobytes().replace(b"\xff", b"\xff\x00")


def _segment(marker: int, payload: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload


def _dht(cls_id: int, spec) -> bytes:
    counts, symbols = spec
    return _segment(0xC4, bytes([cls_id, *counts]) + bytes(symbols))


def encode_jpeg(pixels: np.ndarray, quality: int = 92) -> bytes:
    """(H, W, 3) RGB or (H, W) gray uint8 pixels -> baseline JPEG bytes,
    as PIL's ``Image.fromarray(pixels).save(buf, "JPEG", quality=quality)``
    writes them (module doc)."""
    px = np.asarray(pixels)
    if px.dtype != np.uint8 or not (px.ndim == 2 or (px.ndim == 3 and px.shape[2] in (1, 3))):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8 pixels, got {px.dtype} {px.shape}")
    if px.ndim == 3 and px.shape[2] == 1:
        px = px[..., 0]
    h, w = px.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"image size {w} x {h} out of JPEG's range")
    qtabs = [quant_table(_LUMA_Q, quality), quant_table(_CHROMA_Q, quality)]
    hb, wb = -(-h // 8), -(-w // 8)
    if px.ndim == 2:
        y = quantized_blocks(_pad_edges(px, 8 * hb, 8 * wb), qtabs[0])
        coef = y.reshape(-1, 64)
        comp = np.zeros(len(coef), np.int64)
        components = [(1, 0x11, 0)]
        dc_tables, ac_tables = [_TABLES[_DC_LUMA]], [_TABLES[_AC_LUMA]]
        dht = [_dht(0x00, _DC_LUMA), _dht(0x10, _AC_LUMA)]
        scan = bytes([1, 1, 0x00])
    else:
        lum, cb, cr = rgb_to_ycc(px)
        mr, mc = -(-h // 16), -(-w // 16)
        y = _with_dummies(quantized_blocks(_pad_edges(lum, 8 * hb, 8 * wb), qtabs[0]),
                          2 * mr, 2 * mc)
        # MCU order: the 2 x 2 luma blocks, then Cb, then Cr
        y = y.reshape(mr, 2, mc, 2, 64).transpose(0, 2, 1, 3, 4).reshape(mr, mc, 4, 64)
        chroma = [quantized_blocks(_downsample_h2v2(p, 8 * mr, 8 * mc), qtabs[1])
                  for p in (cb, cr)]
        coef = np.concatenate([y, chroma[0][:, :, None], chroma[1][:, :, None]], axis=2)
        coef = coef.reshape(-1, 64)
        comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mr * mc)
        components = [(1, 0x22, 0), (2, 0x11, 1), (3, 0x11, 1)]
        lum_t, chr_t = _TABLES[_DC_LUMA], _TABLES[_DC_CHROMA]
        dc_tables = [lum_t, chr_t, chr_t]
        ac_tables = [_TABLES[_AC_LUMA], _TABLES[_AC_CHROMA], _TABLES[_AC_CHROMA]]
        dht = [_dht(0x00, _DC_LUMA), _dht(0x10, _AC_LUMA),
               _dht(0x01, _DC_CHROMA), _dht(0x11, _AC_CHROMA)]
        scan = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11])
    words, lens = _scan_symbols(coef, comp, dc_tables, ac_tables)
    head = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t in sorted({c[2] for c in components}):
        head.append(_segment(0xDB, bytes([t]) + bytes(qtabs[t][ZIGZAG].tolist())))
    sof = bytes([8, *h.to_bytes(2, "big"), *w.to_bytes(2, "big"), len(components)])
    head.append(_segment(0xC0, sof + b"".join(bytes(c) for c in components)))
    head += dht
    head.append(_segment(0xDA, scan + bytes([0, 63, 0])))
    return b"".join(head) + pack_bits(words, lens) + b"\xff\xd9"
