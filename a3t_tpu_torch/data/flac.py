"""FLAC codec in Python and numpy (RFC 9639 subset): a copy of
``a3t_tpu/data/flac.py`` with the same encoder decisions, so the port writes
the same bytes as the JAX package for the same input.

The reference pipeline stores formatted audio as FLAC by default
(egs2/TEMPLATE/tts1/format_wav_scp.sh ``audio_format=flac``) and reads it
back through soundfile/libsndfile (espnet2/fileio/sound_scp.py); the port
carries its own codec instead:

* ``write_flac`` — the encoder of the format stage
  (``data/format_wav.py`` with ``audio_format="flac"``).  Emits CONSTANT /
  VERBATIM / FIXED(0-4) / LPC subframes, independent or decorrelated stereo
  (left/side, right/side, mid/side), partitioned-rice residuals with escape
  codes, and wasted-bits packing.
* ``read_flac`` — the decoder (full bitstream support incl. CRC-8/16 and
  MD5 verification).  Mono files read as float go through the C++ decoder
  in ``native/loader/flac.cc``; ``fileio.read_wav`` routes multi-channel
  files and integer reads here.

Layout notes (RFC 9639): stream = "fLaC" magic, metadata blocks
(STREAMINFO first), then frames.  Each frame: byte-aligned header with a
14-bit sync code, coded block size / sample rate / channel assignment /
bit depth, a UTF-8-coded frame number and a CRC-8; one subframe per
channel; zero padding to a byte boundary; CRC-16 of the whole frame.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np

_MAGIC = b"fLaC"

# frame-header code tables (RFC 9639 §9.1)
_BLOCKSIZE_CODES = {192: 1, 576: 2, 1152: 3, 2304: 4, 4608: 5,
                    256: 8, 512: 9, 1024: 10, 2048: 11, 4096: 12,
                    8192: 13, 16384: 14, 32768: 15}
_SAMPLE_SIZE_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_SAMPLE_SIZE_BITS = {v: k for k, v in _SAMPLE_SIZE_CODES.items()}
_SAMPLE_RATE_TABLE = [0, 88200, 176400, 192000, 8000, 16000, 22050, 24000,
                      32000, 44100, 48000, 96000]

_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _crc8(data: bytes) -> int:
    """CRC-8, poly x^8+x^2+x+1 (0x07), init 0 (frame-header CRC)."""
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = ((crc << 1) ^ 0x07) & 0xFF if crc & 0x80 else (crc << 1) & 0xFF
    return crc


def _crc16(data: bytes) -> int:
    """CRC-16, poly 0x8005, init 0 (frame footer CRC)."""
    crc = 0
    for b in data:
        crc ^= b << 8
        for _ in range(8):
            crc = ((crc << 1) ^ 0x8005) & 0xFFFF if crc & 0x8000 \
                else (crc << 1) & 0xFFFF
    return crc


# ---------------------------------------------------------------------------
# bit IO (MSB-first, as the FLAC bitstream requires)
# ---------------------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.bytes = bytearray()
        self._acc = 0
        self._nbits = 0

    def write(self, value: int, nbits: int):
        if nbits == 0:
            return
        self._acc = (self._acc << nbits) | (value & ((1 << nbits) - 1))
        self._nbits += nbits
        while self._nbits >= 8:
            self._nbits -= 8
            self.bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def write_unary(self, q: int):
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)  # q zeros then a one

    def align(self):
        if self._nbits:
            self.write(0, 8 - self._nbits)

    def getvalue(self) -> bytes:
        assert self._nbits == 0
        return bytes(self.bytes)


class _BitReader:
    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.byte_pos = pos
        self._acc = 0
        self._nbits = 0

    def read(self, nbits: int) -> int:
        while self._nbits < nbits:
            self._acc = (self._acc << 8) | self.buf[self.byte_pos]
            self.byte_pos += 1
            self._nbits += 8
        self._nbits -= nbits
        v = self._acc >> self._nbits
        self._acc &= (1 << self._nbits) - 1
        return v

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        return v - (1 << nbits) if v >> (nbits - 1) else v

    def read_unary(self) -> int:
        q = 0
        while self.read(1) == 0:
            q += 1
        return q

    def align(self):
        self._nbits -= self._nbits % 8  # drop partial bits (already read)
        # bits remaining in _acc are whole bytes worth; simpler: clear
        self._acc &= (1 << self._nbits) - 1

    def aligned_pos(self) -> int:
        """Byte offset of the next unread bit (must be byte-aligned)."""
        assert self._nbits % 8 == 0
        return self.byte_pos - self._nbits // 8

    def eof(self) -> bool:
        return self._nbits == 0 and self.byte_pos >= len(self.buf)


def _write_utf8_number(w: _BitWriter, n: int):
    """UTF-8-style coded number, extended to 36 bits (§9.1.5)."""
    if n < 0x80:
        w.write(n, 8)
        return
    for n_follow in range(1, 7):
        if n < (1 << (6 + 5 * n_follow)):  # caps: 11/16/21/26/31/36 bits
            hdr = (0x100 - (1 << (7 - n_follow))) | (n >> (6 * n_follow))
            w.write(hdr, 8)
            for i in range(n_follow - 1, -1, -1):
                w.write(0x80 | ((n >> (6 * i)) & 0x3F), 8)
            return
    raise ValueError(f"frame number too large: {n}")


def _read_utf8_number(r: _BitReader) -> int:
    b0 = r.read(8)
    if b0 < 0x80:
        return b0
    n_follow = 0
    for i in range(6):
        if not (b0 >> (6 - i)) & 1:
            break
        n_follow += 1
    if b0 == 0xFE:
        n_follow = 6
    mask = 0x7F >> (n_follow + 1) if n_follow < 6 else 0
    v = b0 & mask
    for _ in range(n_follow):
        v = (v << 6) | (r.read(8) & 0x3F)
    return v


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _zigzag(res: np.ndarray) -> np.ndarray:
    res = res.astype(np.int64)
    return np.where(res >= 0, res << 1, (-res << 1) - 1)


def _best_rice_param(u: np.ndarray, max_param: int) -> tuple[int, int]:
    """(param, bit cost) minimizing len: n*(k+1) + sum(u >> k)."""
    n = len(u)
    best_k, best_cost = 0, None
    for k in range(max_param + 1):
        cost = n * (k + 1) + int((u >> k).sum())
        if best_cost is None or cost < best_cost:
            best_k, best_cost = k, cost
        elif cost > best_cost * 2:
            break
    return best_k, best_cost


def _write_residual(w: _BitWriter, res: np.ndarray, blocksize: int,
                    order: int, partition_order: int, wide: bool):
    """Partitioned-rice residual (§9.2.7); ``wide`` selects 5-bit params."""
    method, pbits, escape = (1, 5, 31) if wide else (0, 4, 15)
    w.write(method, 2)
    w.write(partition_order, 4)
    u = _zigzag(res)
    pos = 0
    for p in range(1 << partition_order):
        n = (blocksize >> partition_order) - (order if p == 0 else 0)
        part = u[pos:pos + n]
        pos += n
        k, cost = _best_rice_param(part, escape - 1)
        # escape to raw signed values if rice would blow up
        raw_bits = int(part.max(initial=0)).bit_length() + 1 if n else 1
        if n and raw_bits <= 31 and cost > n * raw_bits + 5:
            w.write(escape, pbits)
            w.write(raw_bits, 5)
            for v in res[pos - n:pos]:
                w.write(int(v) & ((1 << raw_bits) - 1), raw_bits)
            continue
        w.write(k, pbits)
        for uv in part:
            uv = int(uv)
            w.write_unary(uv >> k)
            w.write(uv & ((1 << k) - 1), k)


def _residual_cost(res: np.ndarray, max_param: int) -> int:
    u = _zigzag(res)
    _, cost = _best_rice_param(u, max_param)
    return cost if cost is not None else 1 << 62


def _lpc_coefs(x: np.ndarray, order: int, precision: int = 12):
    """Quantized LPC coefficients via autocorrelation + Levinson-Durbin.

    Returns (coefs int list, shift) or None if the block is degenerate.
    """
    xf = x.astype(np.float64)
    n = len(xf)
    if n <= order:
        return None
    # light Welch window keeps the normal equations well-conditioned
    win = 1.0 - (2.0 * np.arange(n) / (n - 1) - 1.0) ** 2 if n > 1 else \
        np.ones(1)
    xw = xf * win
    ac = np.array([np.dot(xw[: n - k], xw[k:]) for k in range(order + 1)])
    if ac[0] == 0:
        return None
    ac[0] *= 1.0 + 1e-9
    err = ac[0]
    a = np.zeros(order)
    for i in range(order):
        acc = ac[i + 1] - np.dot(a[:i], ac[i:0:-1][:i])
        k = acc / err
        a[:i], a[i] = a[:i] - k * a[:i][::-1], k
        err *= 1.0 - k * k
        if err <= 0:
            return None
    cmax = np.abs(a).max()
    if cmax == 0 or not np.isfinite(cmax):
        return None
    shift = precision - 1 - max(0, int(np.floor(np.log2(cmax))) + 1)
    shift = max(1, min(15, shift))
    q = np.clip(np.round(a * (1 << shift)),
                -(1 << (precision - 1)), (1 << (precision - 1)) - 1)
    return q.astype(np.int64), shift


def _predict_lpc(x: np.ndarray, coefs: np.ndarray, shift: int,
                 order: int) -> np.ndarray:
    """Residual of the quantized-LPC predictor over x[order:]."""
    acc = np.zeros(len(x) - order, np.int64)
    for j in range(order):
        acc += coefs[j] * x[order - 1 - j: len(x) - 1 - j]
    return x[order:] - (acc >> shift)


def _encode_subframe(w: _BitWriter, x: np.ndarray, bps: int,
                     lpc_order: int, partition_order: int):
    """Pick the cheapest of CONSTANT / FIXED(0-4) / LPC / VERBATIM."""
    x = x.astype(np.int64)
    n = len(x)

    # wasted bits: trailing zero bits shared by every sample (§9.2.2)
    wasted = 0
    if np.any(x):
        ors = int(np.bitwise_or.reduce(x))
        wasted = (ors & -ors).bit_length() - 1
        wasted = min(wasted, bps - 1)
        if wasted:
            x = x >> wasted
    ebps = bps - wasted

    def header(type_code):
        w.write(0, 1)
        w.write(type_code, 6)
        if wasted:
            w.write(1, 1)
            w.write_unary(wasted - 1)
        else:
            w.write(0, 1)

    if np.all(x == x[0]):
        header(0)  # CONSTANT
        w.write(int(x[0]) & ((1 << ebps) - 1), ebps)
        return

    max_param = 30 if ebps > 16 else 14
    best = ("verbatim", None, n * ebps)
    for order in range(min(5, n)):
        res = np.diff(x, order)
        cost = order * ebps + _residual_cost(res, max_param)
        if cost < best[2]:
            best = ("fixed", order, cost)
    if lpc_order and n > lpc_order * 2:
        lpc = _lpc_coefs(x, lpc_order)
        if lpc is not None:
            coefs, shift = lpc
            res = _predict_lpc(x, coefs, shift, lpc_order)
            cost = (lpc_order * ebps + 4 + 5 + lpc_order * 12
                    + _residual_cost(res, max_param))
            if cost < best[2]:
                best = ("lpc", (coefs, shift, res), cost)

    pred_order = {"fixed": best[1], "lpc": lpc_order}.get(best[0], 0) or 0
    po = partition_order
    while po > 0 and (n % (1 << po) != 0 or (n >> po) <= pred_order):
        po -= 1

    if best[0] == "fixed":
        order = best[1]
        header(0b001000 | order)
        for v in x[:order]:
            w.write(int(v) & ((1 << ebps) - 1), ebps)
        _write_residual(w, np.diff(x, order), n, order, po,
                        wide=ebps > 16)
    elif best[0] == "lpc":
        coefs, shift, res = best[1]
        header(0b100000 | (lpc_order - 1))
        for v in x[:lpc_order]:
            w.write(int(v) & ((1 << ebps) - 1), ebps)
        w.write(12 - 1, 4)  # precision
        w.write(shift, 5)
        for c in coefs:
            w.write(int(c) & 0xFFF, 12)
        _write_residual(w, res, n, lpc_order, po, wide=ebps > 16)
    else:
        header(1)  # VERBATIM
        for v in x:
            w.write(int(v) & ((1 << ebps) - 1), ebps)


def write_flac(path: str, fs: int, data: np.ndarray, bps: int = 16,
               block_size: int = 4096, stereo_mode: str = "auto",
               lpc_order: int = 8, partition_order: int = 2):
    """Encode PCM to FLAC.

    ``data``: int array (n,) or (n, channels) of bps-bit samples, or float
    in [-1, 1] (quantized to ``bps`` like fileio.write_wav).
    ``stereo_mode``: auto | independent | left_side | right_side | mid_side.
    """
    data = np.asarray(data)
    if data.dtype.kind == "f":
        lim = 1 << (bps - 1)
        data = np.clip(np.round(np.clip(data, -1.0, 1.0) * lim),
                       -lim, lim - 1).astype(np.int64)
    else:
        data = data.astype(np.int64)
    if data.ndim == 1:
        data = data[:, None]
    n_total, n_ch = data.shape
    if n_total == 0:
        raise ValueError("empty audio")
    if not 1 <= n_ch <= 8:
        raise ValueError(f"channels {n_ch}")
    if bps not in _SAMPLE_SIZE_CODES:
        raise ValueError(f"bps {bps} unsupported")
    if not 0 < fs < 1 << 20:
        raise ValueError(f"sample rate {fs} out of STREAMINFO's 20-bit range")
    if block_size < 16:
        raise ValueError("FLAC block size must be >= 16")

    # MD5 of the interleaved little-endian signed samples (§8.2)
    nbytes = bps // 8
    raw = np.zeros((n_total * n_ch, nbytes), np.uint8)
    flat = data.reshape(-1)
    for i in range(nbytes):
        raw[:, i] = (flat >> (8 * i)) & 0xFF
    md5 = hashlib.md5(raw.tobytes()).digest()

    frames = bytearray()
    frame_idx = 0
    for start in range(0, n_total, block_size):
        block = data[start:start + block_size]
        bs = len(block)
        w = _BitWriter()
        w.write(0b11111111111110, 14)
        w.write(0, 1)   # reserved
        w.write(0, 1)   # fixed blocking strategy
        bs_code = _BLOCKSIZE_CODES.get(bs, 7)
        w.write(bs_code, 4)
        w.write(0, 4)   # sample rate: from STREAMINFO
        chans = [block[:, c] for c in range(n_ch)]
        ch_bps = [bps] * n_ch
        assign = n_ch - 1
        if n_ch == 2 and stereo_mode != "independent":
            left, right = block[:, 0], block[:, 1]
            side = left - right
            mid = (left + right) >> 1
            costs = {
                "independent": (_residual_cost(np.diff(left), 30)
                                + _residual_cost(np.diff(right), 30)),
                "left_side": (_residual_cost(np.diff(left), 30)
                              + _residual_cost(np.diff(side), 30)),
                "right_side": (_residual_cost(np.diff(side), 30)
                               + _residual_cost(np.diff(right), 30)),
                "mid_side": (_residual_cost(np.diff(mid), 30)
                             + _residual_cost(np.diff(side), 30)),
            }
            mode = stereo_mode if stereo_mode != "auto" \
                else min(costs, key=costs.get)
            if mode == "left_side":
                assign, chans, ch_bps = 8, [left, side], [bps, bps + 1]
            elif mode == "right_side":
                assign, chans, ch_bps = 9, [side, right], [bps + 1, bps]
            elif mode == "mid_side":
                assign, chans, ch_bps = 10, [mid, side], [bps, bps + 1]
        w.write(assign, 4)
        w.write(_SAMPLE_SIZE_CODES[bps], 3)
        w.write(0, 1)   # reserved
        _write_utf8_number(w, frame_idx)
        if bs_code == 7:
            w.write(bs - 1, 16)
        w.align()
        hdr = w.getvalue()
        w = _BitWriter()
        for ch, cb in zip(chans, ch_bps):
            _encode_subframe(w, ch, cb, lpc_order, partition_order)
        w.align()
        body = w.getvalue()
        frame = hdr + bytes([_crc8(hdr)]) + body
        frames += frame + struct.pack(">H", _crc16(frame))
        frame_idx += 1

    si = _BitWriter()
    # spec: min block size excludes the (possibly shorter) last frame
    si.write(min(block_size, n_total), 16)
    si.write(min(block_size, n_total), 16)
    si.write(0, 24)  # min frame size unknown
    si.write(0, 24)  # max frame size unknown
    si.write(fs, 20)
    si.write(n_ch - 1, 3)
    si.write(bps - 1, 5)
    si.write(n_total, 36)
    streaminfo = si.getvalue() + md5

    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(bytes([0x80 | 0]) + struct.pack(">I", len(streaminfo))[1:])
        f.write(streaminfo)
        f.write(frames)


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _read_subframe(r: _BitReader, bs: int, bps: int) -> np.ndarray:
    if r.read(1) != 0:
        raise ValueError("subframe header pad bit set")
    type_code = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = r.read_unary() + 1
    ebps = bps - wasted

    if type_code == 0:  # CONSTANT
        x = np.full(bs, r.read_signed(ebps), np.int64)
    elif type_code == 1:  # VERBATIM
        x = np.array([r.read_signed(ebps) for _ in range(bs)], np.int64)
    elif 8 <= type_code <= 12:  # FIXED
        order = type_code & 0x7
        warm = [r.read_signed(ebps) for _ in range(order)]
        res = _read_residual(r, bs, order)
        x = np.empty(bs, np.int64)
        x[:order] = warm
        coefs = _FIXED_COEFS[order]
        if order == 0:
            x = res
        else:
            for i in range(order, bs):
                x[i] = res[i - order] + sum(
                    c * x[i - 1 - j] for j, c in enumerate(coefs))
    elif type_code >= 32:  # LPC
        order = (type_code & 0x1F) + 1
        warm = [r.read_signed(ebps) for _ in range(order)]
        precision = r.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision code")
        shift = r.read_signed(5)
        if shift < 0:
            raise ValueError("negative LPC shift")
        coefs = [r.read_signed(precision) for _ in range(order)]
        res = _read_residual(r, bs, order)
        x = np.empty(bs, np.int64)
        x[:order] = warm
        for i in range(order, bs):
            acc = 0
            for j in range(order):
                acc += coefs[j] * x[i - 1 - j]
            x[i] = res[i - order] + (acc >> shift)
    else:
        raise ValueError(f"reserved subframe type {type_code}")
    return x << wasted


def _read_residual(r: _BitReader, bs: int, order: int) -> np.ndarray:
    method = r.read(2)
    if method > 1:
        raise ValueError(f"reserved residual method {method}")
    pbits, escape = (5, 31) if method else (4, 15)
    po = r.read(4)
    out = np.empty(bs - order, np.int64)
    pos = 0
    for p in range(1 << po):
        n = (bs >> po) - (order if p == 0 else 0)
        k = r.read(pbits)
        if k == escape:
            rb = r.read(5)
            for i in range(n):
                out[pos + i] = r.read_signed(rb) if rb else 0
        else:
            for i in range(n):
                q = r.read_unary()
                u = (q << k) | (r.read(k) if k else 0)
                out[pos + i] = (u >> 1) ^ -(u & 1)
        pos += n
    return out


def read_flac(path_or_bytes, verify: bool = True):
    """Decode a FLAC file.

    Returns ``(fs, data, bps)`` with ``data`` int32 of shape (n,) for mono
    or (n, channels) otherwise.  ``verify`` checks frame CRCs and, when the
    header carries one, the stream MD5.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        buf = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            buf = f.read()
    if buf[:4] != _MAGIC:
        raise ValueError("not a FLAC stream")
    pos = 4
    fs = n_ch = bps = total = None
    md5 = b"\0" * 16
    while True:
        if pos + 4 > len(buf):
            raise ValueError("truncated metadata block header")
        hdr = buf[pos]
        blen = int.from_bytes(buf[pos + 1:pos + 4], "big")
        btype, last = hdr & 0x7F, bool(hdr & 0x80)
        if pos + 4 + blen > len(buf):
            raise ValueError("metadata block length exceeds stream size")
        payload = buf[pos + 4:pos + 4 + blen]
        if btype == 0:  # STREAMINFO
            if blen < 34:
                raise ValueError("STREAMINFO block too short")
            r = _BitReader(payload)
            r.read(16), r.read(16), r.read(24), r.read(24)
            fs = r.read(20)
            n_ch = r.read(3) + 1
            bps = r.read(5) + 1
            total = r.read(36)
            md5 = payload[18:34]
        pos += 4 + blen
        if last:
            break
    if fs is None:
        raise ValueError("missing STREAMINFO")

    chunks = []
    n_done = 0
    while pos < len(buf) and (total == 0 or n_done < total):
        r = _BitReader(buf, pos)
        if r.read(14) != 0b11111111111110:
            raise ValueError(f"lost frame sync at byte {pos}")
        r.read(1)
        r.read(1)  # blocking strategy (both handled via coded number)
        bs_code = r.read(4)
        sr_code = r.read(4)
        assign = r.read(4)
        ss_code = r.read(3)
        r.read(1)
        _read_utf8_number(r)
        if bs_code == 0:
            raise ValueError("reserved block size code")
        elif bs_code == 1:
            bs = 192
        elif bs_code <= 5:
            bs = 576 << (bs_code - 2)
        elif bs_code == 6:
            bs = r.read(8) + 1
        elif bs_code == 7:
            bs = r.read(16) + 1
        else:
            bs = 256 << (bs_code - 8)
        if sr_code == 12:
            r.read(8)
        elif sr_code in (13, 14):
            r.read(16)
        fbps = bps if ss_code == 0 else _SAMPLE_SIZE_BITS[ss_code]
        hdr_end = r.aligned_pos()
        if verify and _crc8(buf[pos:hdr_end]) != buf[hdr_end]:
            raise ValueError(f"frame header CRC mismatch at byte {pos}")
        r = _BitReader(buf, hdr_end + 1)

        if assign <= 7:
            chans = [_read_subframe(r, bs, fbps) for _ in range(assign + 1)]
        elif assign == 8:    # left/side
            left = _read_subframe(r, bs, fbps)
            side = _read_subframe(r, bs, fbps + 1)
            chans = [left, left - side]
        elif assign == 9:    # right/side
            side = _read_subframe(r, bs, fbps + 1)
            right = _read_subframe(r, bs, fbps)
            chans = [right + side, right]
        elif assign == 10:   # mid/side
            mid = _read_subframe(r, bs, fbps)
            side = _read_subframe(r, bs, fbps + 1)
            mid = (mid << 1) | (side & 1)
            chans = [(mid + side) >> 1, (mid - side) >> 1]
        else:
            raise ValueError(f"reserved channel assignment {assign}")
        r.align()
        end = r.aligned_pos()
        if verify:
            want = struct.unpack(">H", buf[end:end + 2])[0]
            if _crc16(buf[pos:end]) != want:
                raise ValueError(f"frame CRC-16 mismatch at byte {pos}")
        pos = end + 2
        chunks.append(np.stack(chans, 1))
        n_done += bs

    data = np.concatenate(chunks, 0) if chunks else np.zeros((0, n_ch),
                                                             np.int64)
    if total:
        data = data[:total]
    if verify and md5 != b"\0" * 16:
        nbytes = bps // 8
        flat = data.reshape(-1)
        raw = np.zeros((flat.size, nbytes), np.uint8)
        for i in range(nbytes):
            raw[:, i] = (flat >> (8 * i)) & 0xFF
        if hashlib.md5(raw.tobytes()).digest() != md5:
            raise ValueError("stream MD5 mismatch")
    data = data.astype(np.int32)
    if data.shape[1] == 1:
        data = data[:, 0]
    return fs, data, bps


def probe_flac(path: str) -> tuple[int, int]:
    """(n_samples, sample_rate) from STREAMINFO only (header probe)."""
    with open(path, "rb") as f:
        head = f.read(4 + 4 + 34)
    if head[:4] != _MAGIC or (head[4] & 0x7F) != 0:
        raise ValueError("not a FLAC stream")
    r = _BitReader(head[8:])
    r.read(16), r.read(16), r.read(24), r.read(24)
    fs = r.read(20)
    r.read(3)
    r.read(5)
    total = r.read(36)
    return total, fs


def is_flac(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(4) == _MAGIC
