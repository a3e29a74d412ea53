"""Baseline JPEG in numpy: a decoder (Huffman, 8x8 IDCT, 4:4:4 / 4:2:2 /
4:2:0 with libjpeg's fancy chroma upsampling, restart intervals) and a
4:4:4 encoder at a given quality (the IJG tables).

The fitting data are `MASK/*.jpeg`.  Readers try cv2, then PIL, and use
this module only when neither imports: it decodes the same image up to
the IDCT's rounding (a float IDCT here, libjpeg's integer one there; the
tests measure the difference).  Progressive and arithmetic-coded files
raise ValueError.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

# zigzag position k -> natural (row-major) index of the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the DCT basis: M[u, x] = C(u) / 2 cos((2x + 1) u pi / 16), C(0) = 1/sqrt2;
# forward F = M f M^T, inverse f = M^T F M
_U = np.arange(8)[:, None]
_DCT = 0.5 * np.where(_U == 0, 1.0 / np.sqrt(2.0), 1.0) * np.cos(
    (2 * np.arange(8)[None, :] + 1) * _U * np.pi / 16.0)

# IJG base quantization tables (natural order) and the standard Huffman
# tables of ITU T.81 Annex K.3: (bits per code length 1..16, symbols)
_Q_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_Q_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0], list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d], bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f024"
    "33627282090a161718191a25262728292a3435363738393a434445464748494a53"
    "5455565758595a636465666768696a737475767778797a838485868788898a9293"
    "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9"
    "cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa"))
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f015"
    "6272d10a162434e125f11718191a262728292a35363738393a434445464748494a"
    "535455565758595a636465666768696a737475767778797a82838485868788898a"
    "92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7"
    "c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def _codes(bits, symbols) -> Dict[int, Tuple[int, int]]:
    """Canonical Huffman codes: symbol -> (code, length)."""
    out, code, k = {}, 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def _lookup(bits, symbols) -> List[int]:
    """16-bit peek -> symbol << 8 | length (0: no code), as a list (the
    decoder's inner loop indexes it with Python ints)."""
    table = np.zeros(1 << 16, np.int64)
    for sym, (code, length) in _codes(bits, symbols).items():
        lo = code << (16 - length)
        table[lo:lo + (1 << (16 - length))] = (sym << 8) | length
    return table.tolist()


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _segments(data: bytes):
    """(marker, payload) of every marker segment up to SOS, then ('scan',
    entropy-coded bytes up to EOI)."""
    if data[:2] != b"\xff\xd8":
        raise ValueError("not a JPEG file (no SOI)")
    pos = 2
    while pos < len(data):
        while data[pos] == 0xFF and data[pos + 1] == 0xFF:
            pos += 1
        if data[pos] != 0xFF:
            raise ValueError(f"JPEG: expected a marker at byte {pos}")
        marker = data[pos + 1]
        if marker == 0xD9:
            return
        length = (data[pos + 2] << 8) | data[pos + 3]
        payload = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        yield marker, payload
        if marker == 0xDA:
            end = pos
            while True:
                end = data.index(b"\xff", end)
                nxt = data[end + 1]
                if nxt == 0 or 0xD0 <= nxt <= 0xD7:
                    end += 2
                    continue
                break
            yield "scan", data[pos:end]
            pos = end


def _decode_scan(scan: bytes, comps, huff, n_mcu_x: int, n_mcu_y: int, restart: int):
    """Entropy-decode an interleaved baseline scan: per component, its
    blocks' coefficients (rows, cols, 64) in zigzag order."""
    out = [np.zeros((n_mcu_y * c["v"], n_mcu_x * c["h"], 64), np.int32) for c in comps]
    flat_idx: List[List[int]] = [[] for _ in comps]
    flat_val: List[List[int]] = [[] for _ in comps]
    # restart intervals: independent pieces with their own DC predictions
    pieces, start = [], 0
    for i in range(len(scan) - 1):
        if scan[i] == 0xFF and 0xD0 <= scan[i + 1] <= 0xD7:
            pieces.append(scan[start:i])
            start = i + 2
    pieces.append(scan[start:])
    n_mcu = n_mcu_x * n_mcu_y
    per_piece = restart if restart else n_mcu
    mcu = 0
    for piece in pieces:
        if mcu >= n_mcu:
            break
        b = piece.replace(b"\xff\x00", b"\xff") + b"\x00\x00\x00\x00"
        p = 0
        pred = [0] * len(comps)
        for _ in range(min(per_piece, n_mcu - mcu)):
            my, mx = divmod(mcu, n_mcu_x)
            for ci, c in enumerate(comps):
                dc_t, ac_t = huff[(0, c["td"])], huff[(1, c["ta"])]
                width = out[ci].shape[1]
                for v in range(c["v"]):
                    for h in range(c["h"]):
                        base = ((my * c["v"] + v) * width + mx * c["h"] + h) * 64
                        i = p >> 3
                        peek = (((b[i] << 16) | (b[i + 1] << 8) | b[i + 2]) >> (8 - (p & 7))) \
                            & 0xFFFF
                        e = dc_t[peek]
                        p += e & 0xFF
                        s = e >> 8
                        diff = 0
                        if s:
                            i = p >> 3
                            w = (b[i] << 24) | (b[i + 1] << 16) | (b[i + 2] << 8) | b[i + 3]
                            diff = (w >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                            p += s
                            if diff < (1 << (s - 1)):
                                diff -= (1 << s) - 1
                        pred[ci] += diff
                        flat_idx[ci].append(base)
                        flat_val[ci].append(pred[ci])
                        k = 1
                        while k < 64:
                            i = p >> 3
                            peek = (((b[i] << 16) | (b[i + 1] << 8) | b[i + 2])
                                    >> (8 - (p & 7))) & 0xFFFF
                            e = ac_t[peek]
                            if not e & 0xFF:
                                raise ValueError("JPEG: bad Huffman code")
                            p += e & 0xFF
                            rs = e >> 8
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break        # EOB
                                k += 16          # ZRL
                                continue
                            k += r
                            i = p >> 3
                            w = (b[i] << 24) | (b[i + 1] << 16) | (b[i + 2] << 8) | b[i + 3]
                            val = (w >> (32 - (p & 7) - s)) & ((1 << s) - 1)
                            p += s
                            if val < (1 << (s - 1)):
                                val -= (1 << s) - 1
                            if k < 64:
                                flat_idx[ci].append(base + k)
                                flat_val[ci].append(val)
                            k += 1
            mcu += 1
    for ci in range(len(comps)):
        out[ci].reshape(-1)[np.asarray(flat_idx[ci], np.int64)] = flat_val[ci]
    return out


def _idct_plane(coef: np.ndarray, qt: np.ndarray) -> np.ndarray:
    """(rows, cols, 64) zigzag coefficients -> the component's sample
    plane (rows * 8, cols * 8), 0..255 as float (rounded)."""
    rows, cols = coef.shape[:2]
    nat = np.zeros((rows, cols, 64))
    nat[..., ZIGZAG] = coef * qt[ZIGZAG]
    blocks = _DCT.T @ nat.reshape(rows, cols, 8, 8) @ _DCT
    px = np.clip(np.round(blocks + 128.0), 0, 255)
    return px.transpose(0, 2, 1, 3).reshape(rows * 8, cols * 8)


def _upsample(plane: np.ndarray, hf: int, vf: int) -> np.ndarray:
    """Chroma upsampling by (hf, vf): libjpeg's fancy (triangle) filter for
    2x2 and 2x1, pixel replication otherwise."""
    x = plane.astype(np.int64)
    if (hf, vf) == (2, 2):
        up = np.concatenate([x[:1], x[:-1]], axis=0)
        down = np.concatenate([x[1:], x[-1:]], axis=0)
        out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int64)
        for r0, far in ((0, up), (1, down)):
            this = 3 * x + far
            last = np.concatenate([this[:, :1], this[:, :-1]], axis=1)
            nxt = np.concatenate([this[:, 1:], this[:, -1:]], axis=1)
            even = (3 * this + last + 8) >> 4
            odd = (3 * this + nxt + 7) >> 4
            even[:, 0] = (4 * this[:, 0] + 8) >> 4
            odd[:, -1] = (4 * this[:, -1] + 7) >> 4
            out[r0::2, 0::2] = even
            out[r0::2, 1::2] = odd
        return out
    if (hf, vf) == (2, 1):
        last = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
        nxt = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
        out = np.empty((x.shape[0], 2 * x.shape[1]), np.int64)
        out[:, 0::2] = (3 * x + last + 1) >> 2
        out[:, 1::2] = (3 * x + nxt + 2) >> 2
        out[:, 0] = x[:, 0]
        out[:, -1] = x[:, -1]
        return out
    return np.repeat(np.repeat(x, vf, axis=0), hf, axis=1)


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    """libjpeg's fixed-point YCbCr -> RGB (jdcolor.c, 16 fraction bits)."""
    def fix(v):
        return int(v * 65536 + 0.5)

    half = 1 << 15
    cb, cr = cb - 128, cr - 128
    r = y + ((fix(1.40200) * cr + half) >> 16)
    g = y + ((-fix(0.34414) * cb - fix(0.71414) * cr + half) >> 16)
    b = y + ((fix(1.77200) * cb + half) >> 16)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """A baseline JPEG file's bytes -> (H, W, 3) uint8 RGB (a grayscale
    file's one channel repeated)."""
    qts: Dict[int, np.ndarray] = {}
    huff: Dict[Tuple[int, int], List[int]] = {}
    frame, restart, planes = None, 0, None
    for marker, payload in _segments(data):
        if marker == 0xDB:                         # DQT
            pos = 0
            while pos < len(payload):
                pq, tq = payload[pos] >> 4, payload[pos] & 15
                n = 128 if pq else 64
                raw = np.frombuffer(payload[pos + 1:pos + 1 + n], ">u2" if pq else np.uint8)
                q_zz = raw.astype(np.float64)
                q = np.zeros(64)
                q[ZIGZAG] = q_zz
                qts[tq] = q
                pos += 1 + n
        elif marker == 0xC4:                       # DHT
            pos = 0
            while pos < len(payload):
                tc, th = payload[pos] >> 4, payload[pos] & 15
                bits = list(payload[pos + 1:pos + 17])
                n = sum(bits)
                huff[(tc, th)] = _lookup(bits, list(payload[pos + 17:pos + 17 + n]))
                pos += 17 + n
        elif marker in (0xC0, 0xC1):               # SOF0 / SOF1: baseline Huffman
            if payload[0] != 8:
                raise ValueError("JPEG: only 8-bit samples are supported")
            H, W = (payload[1] << 8) | payload[2], (payload[3] << 8) | payload[4]
            comps = []
            for i in range(payload[5]):
                cid, hv, tq = payload[6 + 3 * i:9 + 3 * i]
                comps.append(dict(id=cid, h=hv >> 4, v=hv & 15, tq=tq))
            frame = (H, W, comps)
        elif isinstance(marker, int) and 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8,
                                                                                   0xCC):
            raise ValueError(f"JPEG: unsupported frame type 0x{marker:02X} (baseline only)")
        elif marker == 0xDD:                       # DRI
            restart = (payload[0] << 8) | payload[1]
        elif marker == 0xDA:                       # SOS
            if frame is None:
                raise ValueError("JPEG: scan before frame")
            H, W, comps = frame
            ns = payload[0]
            if ns != len(comps) and len(comps) != 1:
                raise ValueError("JPEG: non-interleaved multi-scan files are not supported")
            by_id = {c["id"]: c for c in comps}
            for i in range(ns):
                cid, t = payload[1 + 2 * i], payload[2 + 2 * i]
                by_id[cid].update(td=t >> 4, ta=t & 15)
        elif marker == "scan":
            H, W, comps = frame
            hmax = max(c["h"] for c in comps)
            vmax = max(c["v"] for c in comps)
            if len(comps) == 1:   # one component: its own block grid, one block an MCU
                comps = [dict(comps[0], h=1, v=1)]
                hmax = vmax = 1
            n_mcu_x = -(-W // (8 * hmax))
            n_mcu_y = -(-H // (8 * vmax))
            coefs = _decode_scan(payload, comps, huff, n_mcu_x, n_mcu_y, restart)
            planes = []
            for c, coef in zip(comps, coefs):
                plane = _idct_plane(coef, qts[c["tq"]])
                ch, cw = -(-H * c["v"] // vmax), -(-W * c["h"] // hmax)
                planes.append(_upsample(plane[:ch, :cw], hmax // c["h"], vmax // c["v"])[:H, :W])
    if planes is None:
        raise ValueError("JPEG: no image data")
    if len(planes) == 1:
        g = planes[0].astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=-1)
    y, cb, cr = (p.astype(np.int64) for p in planes[:3])
    return _ycc_to_rgb(y, cb, cr)


def read_jpeg(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode(f.read())


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def quality_table(base: np.ndarray, quality: int) -> np.ndarray:
    """The IJG scaling of a base table to `quality` (1..100)."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _bits_of(v: int) -> Tuple[int, int]:
    """(category s, the s bits) of a coefficient value."""
    a = -v if v < 0 else v
    s = a.bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def encode(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> baseline JPEG bytes, 4:4:4, the IJG tables
    at `quality`, the standard Huffman tables."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError("encode takes an (H, W, 3) uint8 image")
    H, W = img.shape[:2]
    rgb = img.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    ycc = [0.299 * r + 0.587 * g + 0.114 * b,
           -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
           0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0]
    qts = [quality_table(_Q_LUMA, quality), quality_table(_Q_CHROMA, quality)]
    ph, pw = -(-H // 8) * 8, -(-W // 8) * 8
    quant = []
    for ci, plane in enumerate(ycc):
        p = np.pad(np.round(plane), ((0, ph - H), (0, pw - W)), mode="edge") - 128.0
        blocks = p.reshape(ph // 8, 8, pw // 8, 8).transpose(0, 2, 1, 3)
        coef = _DCT @ blocks @ _DCT.T
        q = qts[0 if ci == 0 else 1].reshape(8, 8)
        quant.append(np.round(coef / q).astype(np.int64).reshape(ph // 8, pw // 8, 64)[..., ZIGZAG])
    tables = [(_codes(*_DC_LUMA), _codes(*_AC_LUMA)), (_codes(*_DC_CHROMA), _codes(*_AC_CHROMA))]
    bw = _BitWriter()
    pred = [0, 0, 0]
    for by in range(ph // 8):
        for bx in range(pw // 8):
            for ci in range(3):
                dc_c, ac_c = tables[0 if ci == 0 else 1]
                zz = quant[ci][by, bx].tolist()
                s, bits = _bits_of(zz[0] - pred[ci])
                pred[ci] = zz[0]
                bw.put(*dc_c[s])
                if s:
                    bw.put(bits, s)
                run = 0
                last = max((k for k in range(1, 64) if zz[k]), default=0)
                for k in range(1, last + 1):
                    v = zz[k]
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        bw.put(*ac_c[0xF0])
                        run -= 16
                    s, bits = _bits_of(v)
                    bw.put(*ac_c[(run << 4) | s])
                    bw.put(bits, s)
                    run = 0
                if last < 63:
                    bw.put(*ac_c[0x00])
    scan = bw.flush()

    def seg(marker: int, payload: bytes) -> bytes:
        return bytes([0xFF, marker]) + (len(payload) + 2).to_bytes(2, "big") + payload

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq, qt in enumerate(qts):
        out += seg(0xDB, bytes([tq]) + bytes(int(v) for v in qt[ZIGZAG]))
    out += seg(0xC0, bytes([8]) + H.to_bytes(2, "big") + W.to_bytes(2, "big") + bytes(
        [3, 1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for tc, th, (bits, syms) in ((0, 0, _DC_LUMA), (1, 0, _AC_LUMA), (0, 1, _DC_CHROMA),
                                 (1, 1, _AC_CHROMA)):
        out += seg(0xC4, bytes([(tc << 4) | th]) + bytes(bits) + bytes(syms))
    out += seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))
    return out + scan + b"\xff\xd9"


def write_jpeg(path: str, img: np.ndarray, quality: int = 95) -> None:
    with open(path, "wb") as f:
        f.write(encode(img, quality))


def resize_linear(img: np.ndarray, size_wh: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C) uint8 by bilinear interpolation at
    half-pixel centres (cv2.INTER_LINEAR's sampling grid)."""
    w, h = size_wh
    H, W = img.shape[:2]
    if (h, w) == (H, W):
        return img.copy()

    def grid(n_out, n_in):
        x = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        x = np.clip(x, 0, n_in - 1)
        i0 = np.floor(x).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, x - i0

    y0, y1, fy = grid(h, H)
    x0, x1, fx = grid(w, W)
    f = img.astype(np.float64)
    top = f[y0][:, x0] * (1 - fx)[None, :, None] + f[y0][:, x1] * fx[None, :, None]
    bot = f[y1][:, x0] * (1 - fx)[None, :, None] + f[y1][:, x1] * fx[None, :, None]
    out = top * (1 - fy)[:, None, None] + bot * fy[:, None, None]
    return np.clip(np.round(out), 0, 255).astype(np.uint8)
