"""PIZ (wavelet + Huffman) codec for OpenEXR scanline blocks.

Decode parity with the reference's EXR reading path, which accepts
arbitrary real-world EXRs through the Rust ``exr`` crate
(crates/raytracing-cpu/src/utils.rs:50-131) — environment maps in the
wild (lat-long HDRs) are typically PIZ-compressed. Encode is also
implemented so the framework can round-trip its own outputs and so the
decoder is testable hermetically.

Layout of a PIZ block (OpenEXR 2.x spec, 32 scanlines):

  u16 minNonZero, u16 maxNonZero        -- bitmap byte range
  u8  bitmap[min..max]                  -- present-u16-values bitset
  u32 length                            -- Huffman section byte count
  huffman data                          -- 20-byte header + code table
                                           + MSB-first bitstream

After Huffman decode the u16 buffer holds each channel's block region
contiguously; each region gets a 2D Haar-style wavelet inverse per u16
plane, then the bitmap-derived LUT maps dense indices back to values,
then rows are interleaved back into scanline order.

`huf_uncompress` prefers the port's native Huffman decode
(csrc/host/exr_huf.cpp through native.py, a copy of the JAX package's);
the pure-Python table-driven decoder below behaves the same and runs where
TPU_RAYTRACING_NO_NATIVE is set.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .. import native

BITMAP_SIZE = 8192
USHORT_RANGE = 1 << 16
HUF_ENCSIZE = USHORT_RANGE + 1
HUF_DECBITS = 14
HUF_DECSIZE = 1 << HUF_DECBITS
HUF_DECMASK = HUF_DECSIZE - 1
SHORT_ZEROCODE_RUN = 59
LONG_ZEROCODE_RUN = 63
SHORTEST_LONG_RUN = 2 + LONG_ZEROCODE_RUN - SHORT_ZEROCODE_RUN  # 6
LONGEST_LONG_RUN = 255 + SHORTEST_LONG_RUN

A_OFFSET = 1 << 15
MOD_MASK = 0xFFFF


# ---------------------------------------------------------------- wavelet

def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int32)
    hs = h.astype(np.int16).astype(np.int32)
    ai = ls + (hs & 1) + (hs >> 1)
    a = ai.astype(np.int16)
    b = (ai - hs).astype(np.int16)
    return a.astype(np.uint16), b.astype(np.uint16)


def _wenc14(a, b):
    as_ = a.astype(np.int16).astype(np.int32)
    bs = b.astype(np.int16).astype(np.int32)
    ms = ((as_ + bs) >> 1).astype(np.int16)
    ds = (as_ - bs).astype(np.int16)
    return ms.astype(np.uint16), ds.astype(np.uint16)


def _wdec16(l, h):
    m = l.astype(np.int32)
    d = h.astype(np.int32)
    bb = (m - (d >> 1)) & MOD_MASK
    aa = (d + bb - A_OFFSET) & MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wenc16(a, b):
    ao = (a.astype(np.int32) + A_OFFSET) & MOD_MASK
    bi = b.astype(np.int32)
    m = (ao + bi) >> 1
    d = ao - bi
    m = np.where(d < 0, (m + A_OFFSET) & MOD_MASK, m)
    d &= MOD_MASK
    return m.astype(np.uint16), d.astype(np.uint16)


def wav2_decode(a: np.ndarray, mx: int) -> None:
    """In-place inverse 2D wavelet over a (ny, nx) u16 view."""
    wdec = _wdec14 if mx < (1 << 14) else _wdec16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, max(ny - p2, 0) + 1, p2) if ny >= p2 else \
            np.empty(0, np.int64)
        xs = np.arange(0, max(nx - p2, 0) + 1, p2) if nx >= p2 else \
            np.empty(0, np.int64)
        if len(ys) and len(xs):
            yy, xx = np.ix_(ys, xs)
            i00, i10 = _pair(wdec, a[yy, xx], a[yy + p, xx])
            i01, i11 = _pair(wdec, a[yy, xx + p], a[yy + p, xx + p])
            a00, a01 = wdec(i00, i01)
            a10, a11 = wdec(i10, i11)
            a[yy, xx] = a00
            a[yy, xx + p] = a01
            a[yy + p, xx] = a10
            a[yy + p, xx + p] = a11
        if (nx & p) and len(ys):
            x = len(xs) * p2
            a00, a10 = wdec(a[ys, x], a[ys + p, x])
            a[ys, x] = a00
            a[ys + p, x] = a10
        if ny & p:
            y = len(ys) * p2
            if len(xs):
                a00, a01 = wdec(a[y, xs], a[y, xs + p])
                a[y, xs] = a00
                a[y, xs + p] = a01
        p2 = p
        p >>= 1


def _pair(wdec, l, h):
    return wdec(l, h)


def wav2_encode(a: np.ndarray, mx: int) -> None:
    """In-place forward 2D wavelet over a (ny, nx) u16 view."""
    wenc = _wenc14 if mx < (1 << 14) else _wenc16
    ny, nx = a.shape
    n = min(nx, ny)
    p = 1
    p2 = 2
    while p2 <= n:
        ys = np.arange(0, max(ny - p2, 0) + 1, p2) if ny >= p2 else \
            np.empty(0, np.int64)
        xs = np.arange(0, max(nx - p2, 0) + 1, p2) if nx >= p2 else \
            np.empty(0, np.int64)
        if len(ys) and len(xs):
            yy, xx = np.ix_(ys, xs)
            i00, i01 = wenc(a[yy, xx], a[yy, xx + p])
            i10, i11 = wenc(a[yy + p, xx], a[yy + p, xx + p])
            l00, l10 = wenc(i00, i10)
            l01, l11 = wenc(i01, i11)
            a[yy, xx] = l00
            a[yy, xx + p] = l01
            a[yy + p, xx] = l10
            a[yy + p, xx + p] = l11
        if (nx & p) and len(ys):
            x = len(xs) * p2
            l00, l10 = wenc(a[ys, x], a[ys + p, x])
            a[ys, x] = l00
            a[ys + p, x] = l10
        if ny & p:
            y = len(ys) * p2
            if len(xs):
                l00, l01 = wenc(a[y, xs], a[y, xs + p])
                a[y, xs] = l00
                a[y, xs + p] = l01
        p = p2
        p2 <<= 1


# ------------------------------------------------------------------- LUTs

def _bitmap_from_data(data: np.ndarray) -> Tuple[np.ndarray, int, int]:
    present = np.zeros(USHORT_RANGE, bool)
    present[np.unique(data)] = True
    present[0] = False  # zero is always implicitly present
    bitmap = np.packbits(present, bitorder="little")
    nz = np.nonzero(bitmap)[0]
    if len(nz):
        return bitmap, int(nz[0]), int(nz[-1])
    return bitmap, BITMAP_SIZE - 1, 0


def _forward_lut(bitmap: np.ndarray) -> Tuple[np.ndarray, int]:
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    lut = np.where(bits, np.cumsum(bits) - 1, 0).astype(np.uint16)
    return lut, int(bits.sum()) - 1


def _reverse_lut(bitmap: np.ndarray) -> Tuple[np.ndarray, int]:
    bits = np.unpackbits(bitmap, bitorder="little")
    bits[0] = 1
    vals = np.nonzero(bits)[0]
    lut = np.zeros(USHORT_RANGE, np.uint16)
    lut[: len(vals)] = vals
    return lut, len(vals) - 1


# ---------------------------------------------------------------- huffman

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.c = 0
        self.lc = 0

    def write(self, n: int, v: int) -> None:
        self.c = (self.c << n) | (v & ((1 << n) - 1))
        self.lc += n
        while self.lc >= 8:
            self.lc -= 8
            self.out.append((self.c >> self.lc) & 0xFF)

    def flush(self) -> int:
        """Pad to a byte; returns total bit count before padding."""
        bits = len(self.out) * 8 + self.lc
        if self.lc:
            self.out.append((self.c << (8 - self.lc)) & 0xFF)
            self.lc = 0
            self.c = 0
        return bits


def _build_code_lengths(freq: np.ndarray) -> np.ndarray:
    """Huffman code lengths (any optimal prefix code is valid PIZ)."""
    import heapq

    syms = np.nonzero(freq)[0]
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    if len(syms) == 1:
        lengths[syms[0]] = 1
        return lengths
    f = freq.astype(np.int64)
    while True:
        heap = [(int(f[s]), int(s), (int(s),)) for s in syms]
        heapq.heapify(heap)
        lens = np.zeros(HUF_ENCSIZE, np.int64)
        while len(heap) > 1:
            fa, _, ta = heapq.heappop(heap)
            fb, tb_id, tb = heapq.heappop(heap)
            for s in ta:
                lens[s] += 1
            for s in tb:
                lens[s] += 1
            heapq.heappush(heap, (fa + fb, tb_id, ta + tb))
        if lens.max() <= 58:
            return lens
        # pathological skew: flatten frequencies and retry
        f = (f + 1) >> 1


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """hcode[i] = (code << 6) | length, canonical assignment."""
    n = np.zeros(59, np.uint64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = np.uint64(0)
    first = np.zeros(59, np.uint64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> np.uint64(1)
        first[i] = c
        c = nc
    hcode = np.zeros(HUF_ENCSIZE, np.uint64)
    counters = first.copy()
    idx = np.nonzero(lengths)[0]
    for i in idx:
        l = int(lengths[i])
        hcode[i] = np.uint64(l) | (counters[l] << np.uint64(6))
        counters[l] += np.uint64(1)
    return hcode


def _pack_enc_table(hcode: np.ndarray, im: int, iM: int) -> bytes:
    bw = _BitWriter()
    i = im
    while i <= iM:
        l = int(hcode[i]) & 63
        if l == 0:
            zerun = 1
            while i < iM and zerun < LONGEST_LONG_RUN:
                if (int(hcode[i + 1]) & 63) > 0:
                    break
                i += 1
                zerun += 1
            if zerun >= 2:
                if zerun >= SHORTEST_LONG_RUN:
                    bw.write(6, LONG_ZEROCODE_RUN)
                    bw.write(8, zerun - SHORTEST_LONG_RUN)
                else:
                    bw.write(6, SHORT_ZEROCODE_RUN + zerun - 2)
                i += 1
                continue
        bw.write(6, l)
        i += 1
    bw.flush()
    return bytes(bw.out)


def huf_compress(raw: np.ndarray) -> bytes:
    """OpenEXR Huffman section for a u16 array (header + table + data)."""
    raw = np.ascontiguousarray(raw, np.uint16).ravel()
    if raw.size == 0:
        return b""
    freq = np.zeros(HUF_ENCSIZE, np.int64)
    counts = np.bincount(raw, minlength=USHORT_RANGE)
    freq[:USHORT_RANGE] = counts
    im = int(np.nonzero(freq)[0][0])
    iM = int(np.nonzero(freq)[0][-1]) + 1  # run-length pseudo-symbol
    freq[iM] = 1
    lengths = _build_code_lengths(freq)
    hcode = _canonical_codes(lengths)
    table = _pack_enc_table(hcode, im, iM)

    bw = _BitWriter()

    def out_code(sym):
        h = int(hcode[sym])
        bw.write(h & 63, h >> 6)

    rl_len = int(hcode[iM]) & 63
    # run-length encode: runs of the same symbol up to 255
    s = int(raw[0])
    cs = 0
    data = raw.tolist()

    def send(sym, run):
        slen = int(hcode[sym]) & 63
        if slen + rl_len + 8 < slen * run:
            out_code(sym)
            out_code(iM)
            bw.write(8, run)
        else:
            for _ in range(run + 1):
                out_code(sym)

    for v in data[1:]:
        if v == s and cs < 255:
            cs += 1
        else:
            send(s, cs)
            cs = 0
            s = v
    send(s, cs)
    n_bits = bw.flush()

    import struct

    header = struct.pack("<IIIII", im, iM, len(table), n_bits, 0)
    return header + table + bytes(bw.out)


def _huf_uncompress_py(comp: bytes, n_out: int) -> np.ndarray:
    """Pure-Python Huffman decode (the JAX package's fallback for its
    csrc/exr_huf.cpp)."""
    import struct

    if len(comp) == 0:
        if n_out:
            raise ValueError("empty huffman data")
        return np.empty(0, np.uint16)
    if len(comp) < 20:
        raise ValueError("truncated huffman header")
    im, iM, _table_len, n_bits, _ = struct.unpack_from("<IIIII", comp, 0)
    if not (0 <= im < HUF_ENCSIZE and 0 <= iM < HUF_ENCSIZE):
        raise ValueError("bad huffman symbol range")
    pos = 20

    # unpack code lengths (6-bit packed with zero-run escapes)
    lengths = np.zeros(HUF_ENCSIZE, np.int64)
    c = 0
    lc = 0
    i = im

    def get_bits(n):
        nonlocal c, lc, pos
        while lc < n:
            if pos >= len(comp):
                raise ValueError("truncated huffman table")
            c = (c << 8) | comp[pos]
            pos += 1
            lc += 8
        lc -= n
        return (c >> lc) & ((1 << n) - 1)

    while i <= iM:
        l = get_bits(6)
        if l == LONG_ZEROCODE_RUN:
            zerun = get_bits(8) + SHORTEST_LONG_RUN
            if i + zerun > iM + 1:
                raise ValueError("bad zero run")
            i += zerun
        elif l >= SHORT_ZEROCODE_RUN:
            zerun = l - SHORT_ZEROCODE_RUN + 2
            if i + zerun > iM + 1:
                raise ValueError("bad zero run")
            i += zerun
        else:
            lengths[i] = l
            i += 1
    hcode = _canonical_codes(lengths)

    if n_bits > 8 * (len(comp) - pos):
        raise ValueError("truncated huffman bitstream")

    # table-driven decode: short codes via a HUF_DECBITS lookup
    codes = (hcode >> np.uint64(6)).astype(np.int64)
    lens = (hcode & np.uint64(63)).astype(np.int64)
    short_sym = np.full(HUF_DECSIZE, -1, np.int64)
    short_len = np.zeros(HUF_DECSIZE, np.int64)
    long_lists: dict = {}
    active = np.nonzero(lens)[0]
    for sym in active:
        l = int(lens[sym])
        cd = int(codes[sym])
        if l > HUF_DECBITS:
            long_lists.setdefault(cd >> (l - HUF_DECBITS), []).append(sym)
        else:
            base = cd << (HUF_DECBITS - l)
            short_sym[base: base + (1 << (HUF_DECBITS - l))] = sym
            short_len[base: base + (1 << (HUF_DECBITS - l))] = l

    out = np.empty(n_out, np.uint16)
    oi = 0
    c = 0
    lc = 0
    end = pos + (n_bits + 7) // 8
    rlc = iM

    def emit(sym):
        nonlocal oi, c, lc, pos
        if sym == rlc:
            if lc < 8:
                c = (c << 8) | comp[pos]
                pos += 1
                lc += 8
            lc -= 8
            cs = (c >> lc) & 0xFF
            if oi + cs > n_out or oi == 0:
                raise ValueError("bad run")
            out[oi: oi + cs] = out[oi - 1]
            oi += cs
        else:
            if oi >= n_out:
                raise ValueError("output overflow")
            out[oi] = sym
            oi += 1

    while pos < end:
        c = (c << 8) | comp[pos]
        pos += 1
        lc += 8
        while lc >= HUF_DECBITS:
            idx = (c >> (lc - HUF_DECBITS)) & HUF_DECMASK
            if short_sym[idx] >= 0:
                lc -= int(short_len[idx])
                emit(int(short_sym[idx]))
            else:
                cands = long_lists.get(idx)
                if not cands:
                    raise ValueError("invalid code")
                for sym in cands:
                    l = int(lens[sym])
                    while lc < l and pos < end:
                        c = (c << 8) | comp[pos]
                        pos += 1
                        lc += 8
                    if lc >= l and int(codes[sym]) == (
                            (c >> (lc - l)) & ((1 << l) - 1)):
                        lc -= l
                        emit(sym)
                        break
                else:
                    raise ValueError("invalid long code")
    i = (8 - n_bits) & 7
    c >>= i
    lc -= i
    while lc > 0:
        idx = ((c << (HUF_DECBITS - lc)) & HUF_DECMASK)
        if short_len[idx] == 0:
            raise ValueError("invalid flush code")
        lc -= int(short_len[idx])
        emit(int(short_sym[idx]))
    if oi != n_out:
        raise ValueError(f"huffman output short: {oi} != {n_out}")
    return out


def huf_uncompress(comp: bytes, n_out: int) -> np.ndarray:
    lib = native.get_lib()
    if lib is not None:
        return native.huf_uncompress_native(lib, comp, n_out)
    return _huf_uncompress_py(comp, n_out)


# -------------------------------------------------------------- PIZ block

def piz_uncompress(block: bytes, channel_sizes: List[int], width: int,
                   ny: int) -> bytes:
    """Decode one PIZ block -> raw scanline bytes.

    channel_sizes: per channel (in header order), pixel size in u16 units
    (HALF=1, FLOAT/UINT=2).
    """
    import struct

    min_nz, max_nz = struct.unpack_from("<HH", block, 0)
    pos = 4
    bitmap = np.zeros(BITMAP_SIZE, np.uint8)
    if max_nz >= BITMAP_SIZE:
        raise ValueError("bad PIZ bitmap range")
    if min_nz <= max_nz:
        n = max_nz - min_nz + 1
        bitmap[min_nz: max_nz + 1] = np.frombuffer(block, np.uint8, n, pos)
        pos += n
    lut, max_value = _reverse_lut(bitmap)
    (length,) = struct.unpack_from("<I", block, pos)
    pos += 4

    total = ny * width * sum(channel_sizes)
    tmp = huf_uncompress(block[pos: pos + length], total)

    start = 0
    for size in channel_sizes:
        n = ny * width * size
        region = tmp[start: start + n].reshape(ny, width * size)
        for j in range(size):
            wav2_decode(region[:, j::size], max_value)
        start += n

    tmp = lut[tmp]
    # regions above are views into tmp pre-LUT; re-slice post-LUT
    out_rows = []
    start = 0
    post = []
    for size in channel_sizes:
        n = ny * width * size
        post.append(tmp[start: start + n].reshape(ny, width * size))
        start += n
    for y in range(ny):
        for region in post:
            out_rows.append(region[y].tobytes())
    return b"".join(out_rows)


def piz_compress(raw: bytes, channel_sizes: List[int], width: int,
                 ny: int) -> bytes:
    """Encode raw scanline bytes -> one PIZ block."""
    import struct

    line_u16 = width * sum(channel_sizes)
    data = np.frombuffer(raw, "<u2").copy()
    assert data.size == ny * line_u16, (data.size, ny, line_u16)

    # de-interleave scanlines into per-channel regions
    rows = data.reshape(ny, line_u16)
    regions = []
    off = 0
    for size in channel_sizes:
        n = width * size
        regions.append(np.ascontiguousarray(rows[:, off: off + n]))
        off += n
    tmp = np.concatenate([r.ravel() for r in regions])

    bitmap, min_nz, max_nz = _bitmap_from_data(tmp)
    lut, max_value = _forward_lut(bitmap)
    tmp = lut[tmp]

    start = 0
    for size in channel_sizes:
        n = ny * width * size
        region = tmp[start: start + n].reshape(ny, width * size)
        for j in range(size):
            wav2_encode(region[:, j::size], max_value)
        start += n

    huf = huf_compress(tmp)
    out = bytearray()
    out += struct.pack("<HH", min_nz, max_nz)
    if min_nz <= max_nz:
        out += bitmap[min_nz: max_nz + 1].tobytes()
    out += struct.pack("<I", len(huf))
    out += huf
    return bytes(out)
