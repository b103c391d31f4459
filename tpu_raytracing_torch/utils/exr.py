"""Minimal OpenEXR 2.0 scanline codec (pure Python; the port's copy of
tpu_raytracing/utils/exr.py).

Capability parity with the reference's exr paths
(crates/raytracing-cpu/src/utils.rs:50-131 writes; the `exr` crate reads
arbitrary real-world files): float32/uint32 channels with arbitrary
names. Supports writing NONE/RLE/ZIP/PIZ/PXR24/B44/B44A scanline files
and reading NONE/RLE/ZIPS/ZIP/PIZ/PXR24/B44/B44A files with
HALF/FLOAT/UINT channels — every compression the reference's `exr`
crate reads — enough to round-trip our own outputs and load lat-long
environment maps in the wild (typically PIZ or B44). DWAA/DWAB (a
DCT-based codec) is detected and reported with a re-encode hint — the
same gap the reference's `exr` crate has. PIZ wavelet/Huffman logic
lives in exr_piz.py; the B44 4x4-block and PXR24 codecs are below.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, Tuple

import numpy as np

MAGIC = 0x01312F76
PIXEL_UINT, PIXEL_HALF, PIXEL_FLOAT = 0, 1, 2
COMP_NONE, COMP_RLE, COMP_ZIPS, COMP_ZIP, COMP_PIZ = 0, 1, 2, 3, 4
COMP_PXR24, COMP_B44, COMP_B44A, COMP_DWAA, COMP_DWAB = 5, 6, 7, 8, 9

_COMP_NAMES = {
    0: "NONE", 1: "RLE", 2: "ZIPS", 3: "ZIP", 4: "PIZ",
    5: "PXR24", 6: "B44", 7: "B44A", 8: "DWAA", 9: "DWAB",
}

_DTYPES = {
    PIXEL_UINT: np.dtype("<u4"),
    PIXEL_HALF: np.dtype("<f2"),
    PIXEL_FLOAT: np.dtype("<f4"),
}


def _attr(name: str, type_name: str, data: bytes) -> bytes:
    return (
        name.encode() + b"\0" + type_name.encode() + b"\0"
        + struct.pack("<i", len(data)) + data
    )


def _chlist(channels: Dict[str, int]) -> bytes:
    out = b""
    for name in sorted(channels):
        out += name.encode() + b"\0"
        out += struct.pack("<iBBBBii", channels[name], 0, 0, 0, 0, 1, 1)
    return out + b"\0"


# EXR zip predictor: delta encode then split bytes into two halves interleaved.
def _zip_reorder_encode(raw: bytes) -> bytes:
    arr = np.frombuffer(raw, np.uint8).astype(np.int16)
    d = arr.copy()
    d[1:] = (arr[1:] - arr[:-1] + 128 + 256) & 0xFF
    d = d.astype(np.uint8)
    half = (len(d) + 1) // 2
    out = np.empty_like(d)
    out[:half] = d[0::2]
    out[half:] = d[1::2]
    return out.tobytes()


def _zip_reorder_decode(data: bytes) -> bytes:
    arr = np.frombuffer(data, np.uint8)
    half = (len(arr) + 1) // 2
    interleaved = np.empty_like(arr)
    interleaved[0::2] = arr[:half]
    interleaved[1::2] = arr[half:]
    # undo delta: d[i] = d[i-1] + raw[i] - 128
    out = np.empty(len(arr), np.uint8)
    prev = int(interleaved[0])
    out[0] = prev
    vals = (np.cumsum(interleaved[1:].astype(np.int64) - 128) + prev) & 0xFF
    out[1:] = vals.astype(np.uint8)
    return out.tobytes()


# --------------------------------------------------------------------------
# RLE: byte runs over the same predictor/byte-split transform as ZIP
# (OpenEXR ImfRleCompressor semantics: signed count byte, negative = literal
# run of -count bytes, non-negative = repeat next byte count+1 times).


def _rle_compress(raw: bytes) -> bytes:
    arr = np.frombuffer(raw, np.uint8)
    out = bytearray()
    i, n = 0, len(arr)
    MAX_RUN = 127
    while i < n:
        # length of the repeat run starting at i
        j = i + 1
        while j < n and j - i < MAX_RUN + 1 and arr[j] == arr[i]:
            j += 1
        if j - i >= 3:
            out.append(j - i - 1)
            out.append(int(arr[i]))
            i = j
        else:
            # literal run until the next >=3 repeat (bounded at 127)
            j = i
            while (
                j < n and j - i < MAX_RUN
                and not (j + 2 < n and arr[j] == arr[j + 1] == arr[j + 2])
            ):
                j += 1
            out.append(256 - (j - i))  # two's-complement negative count
            out.extend(arr[i:j].tobytes())
            i = j
    return bytes(out)


def _rle_decompress(data: bytes, expected: int) -> bytes:
    out = bytearray()
    i, n = 0, len(data)
    while i < n and len(out) < expected:
        count = data[i]
        i += 1
        if count >= 128:  # negative: literal bytes
            cnt = 256 - count
            out.extend(data[i:i + cnt])
            i += cnt
        else:
            out.extend(data[i:i + 1] * (count + 1))
            i += 1
    if len(out) != expected:
        raise ValueError("corrupt RLE EXR data")
    return bytes(out)


# --------------------------------------------------------------------------
# B44 / B44A: HALF channels as packed 4x4 blocks (14 bytes, or 3 for a flat
# B44A block); FLOAT/UINT channels ride uncompressed. Bit layout mirrors
# OpenEXR's ImfB44Compressor unpack14/unpack3. Pixel s[j*4+k] = (row j,
# col k) of the block; deltas chain s0->s4->s8->s12 down the first column
# and s[c]->s[c+1] along rows, each stored as a 6-bit value
# ((delta >> shift) + 0x20).

# (prev, cur, byte layout) for the 15 chained deltas of unpack14: each
# entry is (source index, target index, extractor). Extractors are
# expressed as (byte_hi, hi_shift, byte_lo, lo_shift): the 6-bit field is
# ((b[hi] << hi_shift) | (b[lo] >> lo_shift)) & 0x3f  (lo == -1: no low
# byte; hi_shift == 0 and lo_shift gives a single-byte field).
_B44_CHAIN = (
    (0, 4, (2, 4, 3, 4)),
    (4, 8, (3, 2, 4, 6)),
    (8, 12, (4, 0, -1, 0)),
    (0, 1, (5, 0, -1, 2)),
    (4, 5, (5, 4, 6, 4)),
    (8, 9, (6, 2, 7, 6)),
    (12, 13, (7, 0, -1, 0)),
    (1, 2, (8, 0, -1, 2)),
    (5, 6, (8, 4, 9, 4)),
    (9, 10, (9, 2, 10, 6)),
    (13, 14, (10, 0, -1, 0)),
    (2, 3, (11, 0, -1, 2)),
    (6, 7, (11, 4, 12, 4)),
    (10, 11, (12, 2, 13, 6)),
    (14, 15, (13, 0, -1, 0)),
)


def _b44_transform(s: np.ndarray) -> np.ndarray:
    """half bits -> monotonic unsigned domain (inf/nan collapse to 0x8000)."""
    s = s.astype(np.uint16)
    t = np.where(s & 0x8000, ~s, s | 0x8000).astype(np.uint16)
    return np.where((s & 0x7C00) == 0x7C00, np.uint16(0x8000), t)


def _b44_untransform(t: np.ndarray) -> np.ndarray:
    t = t.astype(np.uint16)
    return np.where(t & 0x8000, t & 0x7FFF, ~t).astype(np.uint16)


def _b44_unpack14(b: np.ndarray) -> np.ndarray:
    """(N, 14) uint8 packed blocks -> (N, 16) uint16 half bits."""
    b = b.astype(np.int32)
    s = np.zeros((b.shape[0], 16), np.int32)
    s[:, 0] = (b[:, 0] << 8) | b[:, 1]
    shift = b[:, 2] >> 2
    bias = 0x20 << shift
    for prev, cur, (hi, hs, lo, ls) in _B44_CHAIN:
        field = b[:, hi] << hs if hs else b[:, hi] >> ls
        if lo >= 0:
            field = field | (b[:, lo] >> ls)
        s[:, cur] = (s[:, prev] + ((field & 0x3F) << shift) - bias) & 0xFFFF
    return _b44_untransform(s.astype(np.uint16))


def _b44_pack_blocks(t: np.ndarray, flat_3byte: bool):
    """(N, 16) uint16 transformed blocks -> list of packed byte strings.

    Shift selection with error feedback: deltas are encoded against the
    RECONSTRUCTED chain (what unpack14 will compute), retrying with a
    larger shift until every 6-bit field is in range. Lossy like the
    original (reconstruction error < 2^shift per step)."""
    n = t.shape[0]
    ti = t.astype(np.int32)
    flat = np.all(ti == ti[:, :1], axis=1) if flat_3byte else np.zeros(n, bool)
    shift = np.zeros(n, np.int32)
    enc = np.zeros((n, 15), np.int32)
    pending = ~flat
    while pending.any():
        rec = np.zeros((n, 16), np.int32)
        rec[:, 0] = ti[:, 0]
        ok = pending.copy()
        for ci, (prev, cur, _) in enumerate(_B44_CHAIN):
            delta = ti[:, cur] - rec[:, prev]
            # round to nearest multiple of 2^shift
            v = (delta + (1 << shift >> 1)) >> shift
            ok &= (v >= -0x20) & (v <= 0x1F)
            v = np.clip(v, -0x20, 0x1F)
            enc[:, ci] = np.where(pending, v + 0x20, enc[:, ci])
            rec[:, cur] = (rec[:, prev] + (v << shift)) & 0xFFFF
        pending &= ~ok
        shift = np.where(pending, shift + 1, shift)
    # assemble the 14-byte layout
    b = np.zeros((n, 14), np.int32)
    b[:, 0] = ti[:, 0] >> 8
    b[:, 1] = ti[:, 0] & 0xFF
    b[:, 2] = shift << 2
    for ci, (_, _, (hi, hs, lo, ls)) in enumerate(_B44_CHAIN):
        v = enc[:, ci]
        if hs:
            b[:, hi] |= (v >> hs) & 0xFF
            if lo >= 0:
                b[:, lo] |= (v << ls) & 0xFF
        else:
            b[:, hi] |= (v << ls) & 0xFF
    packed = b.astype(np.uint8)
    out = []
    for i in range(n):
        if flat[i]:
            out.append(
                bytes((int(ti[i, 0]) >> 8, int(ti[i, 0]) & 0xFF, 0xFC))
            )
        else:
            out.append(packed[i].tobytes())
    return out



def _b44_encode_channel(rows: np.ndarray, b44a: bool) -> bytes:
    """(ny, w) uint16 half bits -> packed B44 bytes (edge-replicated)."""
    ny, w = rows.shape
    py, px = (-ny) % 4, (-w) % 4
    padded = np.pad(rows, ((0, py), (0, px)), mode="edge")
    H, W_ = padded.shape
    blocks = (
        padded.reshape(H // 4, 4, W_ // 4, 4)
        .transpose(0, 2, 1, 3)
        .reshape(-1, 16)
    )
    t = _b44_transform(blocks)
    return b"".join(_b44_pack_blocks(t, flat_3byte=b44a))


def _b44_decode_channel(data: bytes, pos: int, ny: int, w: int,
                        maybe_flat: bool = True):
    """Unpack one HALF channel's blocks -> ((ny, w) uint16, new pos).

    maybe_flat=False (plain B44): every block is 14 bytes, no scan."""
    nby, nbx = (ny + 3) // 4, (w + 3) // 4
    n = nby * nbx
    buf = np.frombuffer(data, np.uint8)
    if not maybe_flat:
        sizes = np.full(n, 14, np.int64)
        p = pos + 14 * n
    else:
        # block sizes: 14 bytes, or 3 when b[2] == 0xfc (B44A flat block)
        sizes = np.empty(n, np.int64)
        p = pos
        for i in range(n):
            if p + 3 > len(buf):
                raise ValueError("corrupt B44 EXR data")
            sizes[i] = 3 if buf[p + 2] == 0xFC else 14
            p += sizes[i]
    if p > len(buf):
        raise ValueError("corrupt B44 EXR data")
    starts = pos + np.concatenate(([0], np.cumsum(sizes[:-1])))
    s = np.empty((n, 16), np.uint16)
    flat = sizes == 3
    if flat.any():
        st = starts[flat]
        v = (
            (buf[st].astype(np.int32) << 8) | buf[st + 1].astype(np.int32)
        ).astype(np.uint16)
        s[flat] = _b44_untransform(v)[:, None]
    full = ~flat
    if full.any():
        st = starts[full]
        idx = st[:, None] + np.arange(14)
        s[full] = _b44_unpack14(buf[idx])
    out = (
        s.reshape(nby, nbx, 4, 4)
        .transpose(0, 2, 1, 3)
        .reshape(nby * 4, nbx * 4)
    )
    return out[:ny, :w], p


# ---------------------------------------------------------------------------
# PXR24 (ImfPxr24Compressor): FLOAT channels rounded to a 24-bit float
# (8-bit exponent, 15-bit mantissa), then per-(scanline, channel) byte
# planes of pixel-to-pixel differences, zlib over the whole block.
# HALF rides lossless as 2 planes, UINT as 4. The one lossy codec the
# reference's `exr` crate reads that round-trips everything we write
# (radiance easily survives 15 mantissa bits).


def _float_to_f24(u: np.ndarray) -> np.ndarray:
    """f32 bit patterns (u32) -> 24-bit float patterns (u32, low byte 0
    dropped), round-to-nearest on the mantissa; NaN keeps a nonzero
    mantissa bit, infinities/denormals follow the f32 encoding."""
    u = u.astype(np.uint32)
    s = (u & np.uint32(0x80000000)) >> np.uint32(8)
    e = u & np.uint32(0x7F800000)
    m = u & np.uint32(0x007FFFFF)
    m2 = (m + np.uint32(0x80)) >> np.uint32(8)
    ovf = (m2 & np.uint32(0x8000)) != 0
    m2 = np.where(ovf, np.uint32(0), m2)
    e2 = e + np.where(ovf, np.uint32(0x00800000), np.uint32(0))
    i24 = (e2 >> np.uint32(8)) | m2
    mn = m >> np.uint32(8)
    nan24 = (e >> np.uint32(8)) | mn | (mn == 0).astype(np.uint32)
    inf24 = e >> np.uint32(8)
    i24 = np.where(
        e == np.uint32(0x7F800000), np.where(m != 0, nan24, inf24), i24
    )
    return (s | i24).astype(np.uint32)


def _pxr24_planes(vals: np.ndarray, nbytes: int) -> bytes:
    """Difference-encode one channel row into nbytes big-endian byte
    planes (plane 0 = most significant byte of each pixel's diff)."""
    d = np.empty_like(vals)
    d[0] = vals[0]
    np.subtract(vals[1:], vals[:-1], out=d[1:])
    planes = [
        ((d >> np.uint32(8 * k)) & np.uint32(0xFF)).astype(np.uint8)
        for k in range(nbytes - 1, -1, -1)
    ]
    return np.concatenate(planes).tobytes()


def _pxr24_unplanes(buf: np.ndarray, pos: int, n: int, nbytes: int):
    """Inverse of _pxr24_planes: read nbytes planes of n diffs starting
    at pos, prefix-sum back to pixel values (u32, wraps mod 2^(8*nbytes)
    like the C accumulation). Returns (values, new pos)."""
    total = nbytes * n
    b = buf[pos:pos + total].astype(np.uint32)
    diff = np.zeros(n, np.uint32)
    for k in range(nbytes):
        diff = (diff << np.uint32(8)) | b[k * n:(k + 1) * n]
    vals = np.cumsum(diff, dtype=np.uint32)
    if nbytes < 4:
        vals &= np.uint32((1 << (8 * nbytes)) - 1)
    return vals, pos + total


def _pxr24_compress(arrs, names, ch_types, y0: int, ny: int) -> bytes:
    parts = []
    for dy in range(ny):
        for name in names:
            row = arrs[name][y0 + dy]
            pt = ch_types[name]
            if pt == PIXEL_FLOAT:
                parts.append(
                    _pxr24_planes(_float_to_f24(row.view("<u4")), 3))
            elif pt == PIXEL_HALF:
                parts.append(
                    _pxr24_planes(row.view("<u2").astype(np.uint32), 2))
            else:
                parts.append(_pxr24_planes(row.view("<u4"), 4))
    return zlib.compress(b"".join(parts))


def _pxr24_decode(data: bytes, channels, ny: int, width: int) -> bytes:
    """Decode one PXR24 block back to the generic scanline-interleaved
    layout (per line, channels in stored order, raw row bytes)."""
    buf = np.frombuffer(zlib.decompress(data), np.uint8)
    pos = 0
    lines = []
    for _ in range(ny):
        for _, pt in channels:
            if pt == PIXEL_FLOAT:
                vals, pos = _pxr24_unplanes(buf, pos, width, 3)
                lines.append(
                    (vals << np.uint32(8)).astype("<u4").tobytes())
            elif pt == PIXEL_HALF:
                vals, pos = _pxr24_unplanes(buf, pos, width, 2)
                lines.append(vals.astype("<u2").tobytes())
            else:
                vals, pos = _pxr24_unplanes(buf, pos, width, 4)
                lines.append(vals.astype("<u4").tobytes())
    return b"".join(lines)


def write_exr(
    path,
    channels: Dict[str, np.ndarray],
    compression: int = COMP_ZIP,
    half: bool = False,
) -> None:
    """Write named channels (each (H, W) float32 or uint32) to an EXR file.

    half=True stores float channels as HALF (required to exercise B44's
    block codec — B44 packs only HALF channels, others ride raw)."""
    names = sorted(channels)
    arrs = {}
    ch_types = {}
    height = width = None
    for name in names:
        a = np.asarray(channels[name])
        if a.dtype == np.uint32:
            ch_types[name] = PIXEL_UINT
            a = a.astype("<u4")
        elif half:
            ch_types[name] = PIXEL_HALF
            a = a.astype("<f2")
        else:
            ch_types[name] = PIXEL_FLOAT
            a = a.astype("<f4")
        if height is None:
            height, width = a.shape
        assert a.shape == (height, width)
        arrs[name] = a

    header = b""
    header += _attr("channels", "chlist", _chlist(ch_types))
    header += _attr("compression", "compression", struct.pack("<B", compression))
    box = struct.pack("<iiii", 0, 0, width - 1, height - 1)
    header += _attr("dataWindow", "box2i", box)
    header += _attr("displayWindow", "box2i", box)
    header += _attr("lineOrder", "lineOrder", struct.pack("<B", 0))
    header += _attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _attr("screenWindowCenter", "v2f", struct.pack("<ff", 0.0, 0.0))
    header += _attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    lines_per_block = {
        COMP_NONE: 1, COMP_RLE: 1, COMP_ZIPS: 1, COMP_ZIP: 16,
        COMP_PIZ: 32, COMP_B44: 32, COMP_B44A: 32, COMP_PXR24: 16,
    }[compression]
    n_blocks = (height + lines_per_block - 1) // lines_per_block

    def line_bytes_of(ny):
        return ny * width * sum(
            _DTYPES[ch_types[n]].itemsize for n in names
        )

    blocks = []
    for bi in range(n_blocks):
        y0 = bi * lines_per_block
        ny = min(lines_per_block, height - y0)
        if compression in (COMP_B44, COMP_B44A):
            # per-channel sections: HALF channels as packed 4x4 blocks,
            # FLOAT/UINT raw (ImfB44Compressor layout). No HALF channels
            # means no shrink, and readers treat size == raw as the plain
            # scanline format — store raw then.
            parts = []
            for name in names:
                rows = arrs[name][y0:y0 + ny]
                if ch_types[name] == PIXEL_HALF:
                    parts.append(_b44_encode_channel(
                        rows.view("<u2"), compression == COMP_B44A))
                else:
                    parts.append(rows.tobytes())
            data = b"".join(parts)
            if len(data) >= line_bytes_of(ny):
                data = b"".join(
                    arrs[name][y0 + dy].tobytes()
                    for dy in range(ny) for name in names
                )
            blocks.append((y0, data))
            continue
        # scanline data: for each line, channels in alphabetical order
        parts = []
        for dy in range(ny):
            for name in names:
                parts.append(arrs[name][y0 + dy].tobytes())
        raw = b"".join(parts)
        if compression == COMP_NONE:
            data = raw
        elif compression == COMP_RLE:
            comp = _rle_compress(_zip_reorder_encode(raw))
            data = comp if len(comp) < len(raw) else raw
        elif compression == COMP_PIZ:
            from .exr_piz import piz_compress

            sizes = [_DTYPES[ch_types[n]].itemsize // 2 for n in names]
            comp = piz_compress(raw, sizes, width, ny)
            data = comp if len(comp) < len(raw) else raw
        elif compression == COMP_PXR24:
            comp = _pxr24_compress(arrs, names, ch_types, y0, ny)
            data = comp if len(comp) < len(raw) else raw
        else:
            comp = zlib.compress(_zip_reorder_encode(raw))
            data = comp if len(comp) < len(raw) else raw
        blocks.append((y0, data))

    with open(path, "wb") as f:
        f.write(struct.pack("<Ii", MAGIC, 2))
        f.write(header)
        offset_table_pos = f.tell()
        offset = offset_table_pos + 8 * n_blocks
        offsets = []
        for _, data in blocks:
            offsets.append(offset)
            offset += 8 + len(data)
        f.write(struct.pack(f"<{n_blocks}Q", *offsets))
        for y0, data in blocks:
            f.write(struct.pack("<ii", y0, len(data)))
            f.write(data)


def read_exr_bytes(raw: bytes) -> Tuple[Dict[str, np.ndarray], int, int]:
    """Parse an EXR byte string -> ({channel: (H, W) f32/u32}, width, height)."""
    magic, version = struct.unpack_from("<Ii", raw, 0)
    if magic != MAGIC:
        raise ValueError("not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    pos = 8

    def read_cstr():
        nonlocal pos
        end = raw.index(b"\0", pos)
        s = raw[pos:end].decode("latin-1")
        pos = end + 1
        return s

    channels = []  # (name, pixel_type)
    compression = COMP_NONE
    data_window = None
    while True:
        name = read_cstr()
        if not name:
            break
        _type_name = read_cstr()
        (size,) = struct.unpack_from("<i", raw, pos)
        pos += 4
        payload = raw[pos:pos + size]
        pos += size
        if name == "channels":
            cp = 0
            while payload[cp] != 0:
                ce = payload.index(b"\0", cp)
                cname = payload[cp:ce].decode("latin-1")
                (ptype,) = struct.unpack_from("<i", payload, ce + 1)
                channels.append((cname, ptype))
                cp = ce + 1 + 16
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            data_window = struct.unpack("<iiii", payload)

    x_min, y_min, x_max, y_max = data_window
    width = x_max - x_min + 1
    height = y_max - y_min + 1
    supported = (
        COMP_NONE, COMP_RLE, COMP_ZIPS, COMP_ZIP, COMP_PIZ,
        COMP_PXR24, COMP_B44, COMP_B44A,
    )
    if compression not in supported:
        name = _COMP_NAMES.get(compression, str(compression))
        raise ValueError(
            f"unsupported EXR compression {name}: re-encode the file, e.g. "
            f"`oiiotool in.exr --compression zip -o out.exr` or "
            f"`exrmaketiled`/`exrenvmap` with -z zip"
        )
    lines_per_block = {
        COMP_NONE: 1, COMP_RLE: 1, COMP_ZIPS: 1, COMP_ZIP: 16,
        COMP_PIZ: 32, COMP_B44: 32, COMP_B44A: 32, COMP_PXR24: 16,
    }[compression]
    n_blocks = (height + lines_per_block - 1) // lines_per_block

    offsets = struct.unpack_from(f"<{n_blocks}Q", raw, pos)
    line_bytes = sum(_DTYPES[pt].itemsize for _, pt in channels) * width

    out = {
        cname: np.empty((height, width), _DTYPES[pt])
        for cname, pt in channels
    }
    for off in offsets:
        y0, size = struct.unpack_from("<ii", raw, off)
        data = raw[off + 8:off + 8 + size]
        ny = min(lines_per_block, height - (y0 - y_min))
        expected = line_bytes * ny
        if size != expected and compression in (COMP_B44, COMP_B44A):
            # per-channel sections (HALF packed, FLOAT/UINT raw)
            p = 0
            y = y0 - y_min
            for cname, pt in channels:
                if pt == PIXEL_HALF:
                    rows, p = _b44_decode_channel(
                        data, p, ny, width,
                        maybe_flat=compression == COMP_B44A)
                    out[cname][y:y + ny] = rows.view("<f2")
                else:
                    dt = _DTYPES[pt]
                    nbytes = ny * width * dt.itemsize
                    out[cname][y:y + ny] = np.frombuffer(
                        data, dt, ny * width, p).reshape(ny, width)
                    p += nbytes
            continue
        if size != expected:
            if compression == COMP_PIZ:
                from .exr_piz import piz_uncompress

                sizes = [_DTYPES[pt].itemsize // 2 for _, pt in channels]
                data = piz_uncompress(data, sizes, width, ny)
            elif compression == COMP_RLE:
                data = _zip_reorder_decode(_rle_decompress(data, expected))
            elif compression == COMP_PXR24:
                data = _pxr24_decode(data, channels, ny, width)
            else:
                data = _zip_reorder_decode(zlib.decompress(data))
        p = 0
        for dy in range(ny):
            y = y0 - y_min + dy
            for cname, pt in channels:
                dt = _DTYPES[pt]
                row = np.frombuffer(data, dt, width, p)
                out[cname][y] = row
                p += dt.itemsize * width

    result = {}
    for cname, pt in channels:
        a = out[cname]
        result[cname] = (
            a.astype(np.uint32) if pt == PIXEL_UINT else a.astype(np.float32)
        )
    return result, width, height


def read_exr(path) -> Tuple[Dict[str, np.ndarray], int, int]:
    with open(path, "rb") as f:
        return read_exr_bytes(f.read())
