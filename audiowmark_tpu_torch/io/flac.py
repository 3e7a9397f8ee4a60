"""Pure-numpy FLAC codec (no external libraries).

The reference reads FLAC through libsndfile (src/sfinputstream.cc:75-149) and
writes FLAC for the HLS piggyback payload (src/sfoutputstream.cc:52-66,
src/hls.cc:389-618).  This image has neither libsndfile nor ffmpeg, so we
implement the subset of FLAC the framework needs natively:

* decoder: full subframe coverage — constant, verbatim, fixed (orders 0-4)
  and LPC, rice/rice2 residual partitions with escape codes, wasted bits,
  and all stereo decorrelation modes (independent, left/side, right/side,
  mid/side); 8..32-bit sample sizes.
* encoder: fixed-blocksize streams with verbatim subframes (byte-aligned
  16/24-bit fast path — what the HLS path uses, so multi-minute masters
  encode/decode at memcpy speed) and an optional order-2 fixed-predictor +
  rice mode used by the tests to exercise the residual decode path.

Container quantization matches the WAV writer (trunc-clip f*2^31), so a
WAV->FLAC->WAV round trip is bit-exact on the PCM words.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Tuple

import numpy as np

from ..params import Encoding
from .streams import AudioInputStream

_BLOCK = 4096

# sample-rate header codes (subset with exact table entries)
_SR_CODES = {88200: 1, 176400: 2, 192000: 3, 8000: 4, 16000: 5, 22050: 6,
             24000: 7, 32000: 8, 44100: 9, 48000: 10, 96000: 11}
_SR_TABLE = {v: k for k, v in _SR_CODES.items()}
_SS_CODES = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}
_SS_TABLE = {v: k for k, v in _SS_CODES.items()}


class FlacError(Exception):
    pass


def flac_detect(filename: str) -> bool:
    try:
        with open(filename, "rb") as f:
            return f.read(4) == b"fLaC"
    except OSError:
        return False


# ---- CRCs (frame header crc8 poly 0x07, frame crc16 poly 0x8005) ------------

def _make_crc_table(poly: int, width: int) -> np.ndarray:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i << (width - 8)
        for _ in range(8):
            c = ((c << 1) ^ poly) if (c & top) else (c << 1)
        table[i] = c & mask
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    c = 0
    for b in data:
        c = int(_CRC8_TABLE[c ^ b])
    return c


# CRC-16 is linear over GF(2): crc(msg) = XOR over set bits of the
# per-(distance-from-end, bit) contribution crc((1<<bit) << 8*d).  The
# contribution table is built incrementally and cached, making frame CRCs
# one vectorized XOR-reduce instead of a per-byte Python loop.
_CRC16_CONTRIB = np.zeros((0, 8), dtype=np.uint16)


def _crc16_contrib(n: int) -> np.ndarray:
    global _CRC16_CONTRIB
    if _CRC16_CONTRIB.shape[0] < n:
        old = _CRC16_CONTRIB
        grow = max(n, 2 * old.shape[0], 4096)
        tbl = np.empty((grow, 8), dtype=np.uint16)
        if old.shape[0]:
            tbl[:old.shape[0]] = old
            start = old.shape[0]
        else:
            tbl[0] = _CRC16_TABLE[1 << np.arange(8)].astype(np.uint16)
            start = 1
        t16 = _CRC16_TABLE.astype(np.uint16)
        for d in range(start, grow):
            v = tbl[d - 1]
            tbl[d] = t16[v >> 8] ^ (v << 8)  # advance by one zero byte
        _CRC16_CONTRIB = tbl
    return _CRC16_CONTRIB


def _crc16(data: bytes) -> int:
    n = len(data)
    if n == 0:
        return 0
    contrib = _crc16_contrib(n)
    arr = np.frombuffer(data, dtype=np.uint8)
    bits = ((arr[:, None] >> np.arange(8, dtype=np.uint8)[None, :]) & 1)
    vals = contrib[n - 1::-1] * bits.astype(np.uint16)
    return int(np.bitwise_xor.reduce(vals, axis=None))


# ---- UTF-8-style frame numbers ----------------------------------------------

def _utf8_encode(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    for n_bytes, first_max in ((2, 11), (3, 16), (4, 21), (5, 26), (6, 31)):
        if v < (1 << first_max):
            out = bytearray(n_bytes)
            for i in range(n_bytes - 1, 0, -1):
                out[i] = 0x80 | (v & 0x3F)
                v >>= 6
            out[0] = (0xFF << (8 - n_bytes) & 0xFF) | v
            return bytes(out)
    raise FlacError("frame number too large")


# ---- bit reader --------------------------------------------------------------

class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
        self._ones = None  # lazy: only rice/wasted-bits decoding needs it
        self.pos = 0
        self._pow = (1 << np.arange(23, -1, -1)).astype(np.int64)

    @property
    def ones(self) -> np.ndarray:
        """Positions of set bits (built lazily — verbatim streams, like the
        HLS payload, never read unary codes and skip the ~4x memory cost)."""
        if self._ones is None:
            self._ones = np.flatnonzero(self.bits)
        return self._ones

    def read_uint(self, n: int) -> int:
        if self.pos + n > self.bits.size:
            raise FlacError("unexpected end of stream")
        v = 0
        pos = self.pos
        while n > 24:
            v = (v << 24) | int(self.bits[pos:pos + 24] @ self._pow)
            pos += 24
            n -= 24
        if n:
            v = (v << n) | int(self.bits[pos:pos + n] @ self._pow[24 - n:])
            pos += n
        self.pos = pos
        return v

    def read_sint(self, n: int) -> int:
        v = self.read_uint(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        i = np.searchsorted(self.ones, self.pos)
        if i >= self.ones.size:
            raise FlacError("unexpected end of stream")
        nxt = int(self.ones[i])
        q = nxt - self.pos
        self.pos = nxt + 1
        return q

    def align_byte(self):
        self.pos = (self.pos + 7) & ~7

    def read_aligned_ints(self, count: int, bits: int) -> np.ndarray:
        """Fast path: `count` big-endian signed ints at a byte boundary."""
        assert self.pos % 8 == 0 and bits % 8 == 0
        start = self.pos // 8
        nbytes = bits // 8
        if start + count * nbytes > len(self.data):
            raise FlacError("unexpected end of stream")
        raw = np.frombuffer(self.data, dtype=np.uint8,
                            count=count * nbytes, offset=start)
        raw = raw.reshape(count, nbytes).astype(np.int64)
        v = np.zeros(count, dtype=np.int64)
        for b in range(nbytes):
            v = (v << 8) | raw[:, b]
        v -= (v >= (1 << (bits - 1))).astype(np.int64) << bits
        self.pos += count * bits
        return v


# ---- bit writer --------------------------------------------------------------

class _BitWriter:
    def __init__(self):
        self.chunks: List[np.ndarray] = []
        self.nbits = 0

    def write_uint(self, v: int, n: int):
        bits = np.empty(n, dtype=np.uint8)
        for i in range(n - 1, -1, -1):
            bits[i] = v & 1
            v >>= 1
        self.chunks.append(bits)
        self.nbits += n

    def write_sint(self, v: int, n: int):
        self.write_uint(v & ((1 << n) - 1), n)

    def write_unary(self, q: int):
        bits = np.zeros(q + 1, dtype=np.uint8)
        bits[q] = 1
        self.chunks.append(bits)
        self.nbits += q + 1

    def write_sints_vec(self, vals: np.ndarray, n: int):
        """Vectorized: each value as an n-bit two's-complement field."""
        u = (vals.astype(np.int64) & ((1 << n) - 1)).astype(np.uint64)
        shifts = np.arange(n - 1, -1, -1, dtype=np.uint64)
        bits = ((u[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
        self.chunks.append(bits.reshape(-1))
        self.nbits += n * vals.size

    def getvalue(self) -> bytes:
        bits = (np.concatenate(self.chunks) if self.chunks
                else np.zeros(0, dtype=np.uint8))
        return np.packbits(bits).tobytes()


# ---- decoder -----------------------------------------------------------------

def _decode_residual(br: _BitReader, block_size: int, order: int) -> np.ndarray:
    method = br.read_uint(2)
    if method > 1:
        raise FlacError("reserved residual coding method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    porder = br.read_uint(4)
    n_part = 1 << porder
    if block_size % n_part or (block_size >> porder) < order:
        raise FlacError("bad partition order")
    out = np.empty(block_size - order, dtype=np.int64)
    filled = 0
    for p in range(n_part):
        n = block_size >> porder
        if p == 0:
            n -= order
        k = br.read_uint(plen)
        if k == escape:
            raw_bits = br.read_uint(5)
            for i in range(n):
                out[filled + i] = br.read_sint(raw_bits) if raw_bits else 0
        else:
            for i in range(n):
                q = br.read_unary()
                u = (q << k) | (br.read_uint(k) if k else 0)
                out[filled + i] = (u >> 1) ^ -(u & 1)
        filled += n
    return out


def _restore_fixed(warm: np.ndarray, res: np.ndarray, order: int) -> np.ndarray:
    if order == 0:
        return res
    diffs = [warm.astype(np.int64)]
    for _ in range(order):
        diffs.append(np.diff(diffs[-1]))
    seq = res
    for j in range(order, 0, -1):
        seq = diffs[j - 1][-1] + np.cumsum(seq)
    return seq


def _decode_subframe(br: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if br.read_uint(1):
        raise FlacError("bad subframe padding bit")
    sf_type = br.read_uint(6)
    wasted = 0
    if br.read_uint(1):
        wasted = br.read_unary() + 1
    bps -= wasted
    if sf_type == 0:  # constant
        out = np.full(block_size, br.read_sint(bps), dtype=np.int64)
    elif sf_type == 1:  # verbatim
        if br.pos % 8 == 0 and bps % 8 == 0:
            out = br.read_aligned_ints(block_size, bps)
        else:
            out = np.array([br.read_sint(bps) for _ in range(block_size)],
                           dtype=np.int64)
    elif 8 <= sf_type <= 12:  # fixed, order = type - 8
        order = sf_type - 8
        warm = np.array([br.read_sint(bps) for _ in range(order)],
                        dtype=np.int64)
        res = _decode_residual(br, block_size, order)
        out = np.concatenate([warm, _restore_fixed(warm, res, order)])
    elif sf_type >= 32:  # LPC, order = (type & 31) + 1
        order = (sf_type & 31) + 1
        warm = [br.read_sint(bps) for _ in range(order)]
        precision = br.read_uint(4) + 1
        if precision == 16:
            raise FlacError("bad qlp precision")
        shift = br.read_sint(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coefs = [br.read_sint(precision) for _ in range(order)]
        res = _decode_residual(br, block_size, order)
        out = np.empty(block_size, dtype=np.int64)
        out[:order] = warm
        samples = out  # python-int loop; LPC files are rare in our use
        for i in range(order, block_size):
            pred = 0
            for j in range(order):
                pred += coefs[j] * int(samples[i - 1 - j])
            samples[i] = int(res[i - order]) + (pred >> shift)
    else:
        raise FlacError("reserved subframe type %d" % sf_type)
    if wasted:
        out = out << wasted
    return out


def _decode_frame(br: _BitReader, info: dict) -> Optional[np.ndarray]:
    """Decode one frame; returns (block_size, n_channels) int32 array."""
    # resync tolerance: frames are byte-aligned back to back in our streams
    if br.pos >= br.bits.size - 16:
        return None
    sync = br.read_uint(14)
    if sync != 0x3FFE:
        raise FlacError("lost frame sync")
    br.read_uint(1)  # reserved
    br.read_uint(1)  # blocking strategy
    bs_code = br.read_uint(4)
    sr_code = br.read_uint(4)
    chan_code = br.read_uint(4)
    ss_code = br.read_uint(3)
    br.read_uint(1)  # reserved
    # UTF-8 coded frame/sample number
    first = br.read_uint(8)
    n_follow = 0
    if first >= 0xC0:
        b = first
        while b & 0x40:
            n_follow += 1
            b <<= 1
    for _ in range(n_follow):
        br.read_uint(8)
    if bs_code == 0:
        raise FlacError("reserved block size code")
    elif bs_code == 1:
        block_size = 192
    elif bs_code <= 5:
        block_size = 576 << (bs_code - 2)
    elif bs_code == 6:
        block_size = br.read_uint(8) + 1
    elif bs_code == 7:
        block_size = br.read_uint(16) + 1
    else:
        block_size = 256 << (bs_code - 8)
    if sr_code == 12:
        br.read_uint(8)
    elif sr_code in (13, 14):
        br.read_uint(16)
    br.read_uint(8)  # header crc8 (not verified)
    bps = info["bps"] if ss_code == 0 else _SS_TABLE.get(ss_code)
    if bps is None:
        raise FlacError("reserved sample size code")
    if chan_code < 8:
        n_channels = chan_code + 1
        chans = [_decode_subframe(br, block_size, bps)
                 for _ in range(n_channels)]
    elif chan_code <= 10:
        n_channels = 2
        bps0 = bps + (1 if chan_code == 9 else 0)
        bps1 = bps + (1 if chan_code in (8, 10) else 0)
        c0 = _decode_subframe(br, block_size, bps0)
        c1 = _decode_subframe(br, block_size, bps1)
        if chan_code == 8:      # left/side
            chans = [c0, c0 - c1]
        elif chan_code == 9:    # right/side
            chans = [c0 + c1, c1]
        else:                   # mid/side
            m = (c0 << 1) | (c1 & 1)
            chans = [(m + c1) >> 1, (m - c1) >> 1]
    else:
        raise FlacError("reserved channel assignment")
    br.align_byte()
    br.read_uint(16)  # frame crc16 (not verified)
    out = np.empty((block_size, n_channels), dtype=np.int64)
    for c, ch in enumerate(chans):
        out[:, c] = ch
    return out


def decode_flac(data: bytes) -> Tuple[np.ndarray, int, int, int]:
    """Decode a FLAC stream.

    Returns (interleaved float32 samples, n_channels, sample_rate, bps).
    Float normalization is sample / 2^(bps-1), matching the WAV reader's
    integer-PCM path.
    """
    if data[:4] != b"fLaC":
        raise FlacError("not a FLAC stream")
    pos = 4
    info = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = data[pos]
        length = int.from_bytes(data[pos + 1:pos + 4], "big")
        if (hdr & 0x7F) == 0:  # STREAMINFO
            si = data[pos + 4:pos + 4 + 34]
            if len(si) < 34:
                raise FlacError("short STREAMINFO")
            rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4)
            n_channels = ((si[12] >> 1) & 0x7) + 1
            bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1
            total = (((si[13] & 0x0F) << 32) |
                     int.from_bytes(si[14:18], "big"))
            info = {"rate": rate, "channels": n_channels, "bps": bps,
                    "total": total}
        pos += 4 + length
        if hdr & 0x80:
            break
    if info is None:
        raise FlacError("missing STREAMINFO")
    br = _BitReader(data[pos:])
    blocks = []
    got = 0
    while True:
        if info["total"] and got >= info["total"]:
            break
        frame = _decode_frame(br, info)
        if frame is None:
            break
        blocks.append(frame)
        got += frame.shape[0]
    pcm = (np.concatenate(blocks, axis=0) if blocks
           else np.zeros((0, info["channels"]), dtype=np.int64))
    if info["total"]:
        pcm = pcm[:info["total"]]
    # float32 multiply by a power of two, matching the WAV reader's
    # int-PCM normalization path exactly
    samples = pcm.astype(np.float32) * np.float32(1.0 / (1 << (info["bps"] - 1)))
    return samples.reshape(-1), info["channels"], info["rate"], info["bps"]


# ---- encoder -----------------------------------------------------------------

def _int_samples(samples: np.ndarray, bit_depth: int) -> np.ndarray:
    """Quantize float32 like the WAV writer (trunc-clip of f*2^31)."""
    from .wavfile import float_to_int_clip32
    s = float_to_int_clip32(np.asarray(samples, dtype=np.float32))
    return (s >> (32 - bit_depth)).astype(np.int64)


def _rice_k(res: np.ndarray) -> int:
    mean = float(np.mean(np.abs(res))) if res.size else 0.0
    k = 0
    while (1 << k) < mean and k < 14:
        k += 1
    return k


def _encode_subframe_fixed2(bw: _BitWriter, ch: np.ndarray, bps: int):
    """Order-2 fixed predictor + one rice partition (test/coverage mode)."""
    order = 2
    bw.write_uint(0, 1)
    bw.write_uint(8 + order, 6)  # fixed, order 2
    bw.write_uint(0, 1)          # no wasted bits
    for v in ch[:order]:
        bw.write_sint(int(v), bps)
    res = ch[order:] - 2 * ch[1:-1] + ch[:-2]
    bw.write_uint(0, 2)  # rice 4-bit params
    bw.write_uint(0, 4)  # partition order 0
    k = _rice_k(res)
    bw.write_uint(k, 4)
    for r in res:
        u = (int(r) << 1) ^ (int(r) >> 63)  # zigzag
        bw.write_unary(u >> k)
        if k:
            bw.write_uint(u & ((1 << k) - 1), k)


def _encode_frame(frame: np.ndarray, frame_idx: int, rate: int, bps: int,
                  mode: str) -> bytes:
    block_size, n_channels = frame.shape
    hdr = bytearray([0xFF, 0xF8])
    if block_size == _BLOCK:
        bs_code, bs_extra = 12, b""
    else:
        bs_code, bs_extra = 7, struct.pack(">H", block_size - 1)
    sr_code = _SR_CODES.get(rate)
    sr_extra = b""
    if sr_code is None:
        if rate < 65536:
            sr_code, sr_extra = 13, struct.pack(">H", rate)
        elif rate % 10 == 0 and rate // 10 < 65536:
            sr_code, sr_extra = 14, struct.pack(">H", rate // 10)
        else:
            sr_code = 0  # from STREAMINFO
    hdr.append((bs_code << 4) | sr_code)
    hdr.append(((n_channels - 1) << 4) | (_SS_CODES[bps] << 1))
    hdr += _utf8_encode(frame_idx)
    hdr += bs_extra + sr_extra
    hdr.append(_crc8(bytes(hdr)))
    body = bytearray(hdr)
    if mode == "verbatim" and bps % 8 == 0:
        # byte-aligned fast path
        for c in range(n_channels):
            body.append(0x02)  # verbatim subframe header
            ch = frame[:, c] & ((1 << bps) - 1)
            nbytes = bps // 8
            raw = np.empty((block_size, nbytes), dtype=np.uint8)
            for b in range(nbytes):
                raw[:, nbytes - 1 - b] = (ch >> (8 * b)) & 0xFF
            body += raw.tobytes()
    else:
        bw = _BitWriter()
        for c in range(n_channels):
            ch = frame[:, c]
            if mode == "fixed" and block_size > 2:
                _encode_subframe_fixed2(bw, ch, bps)
            else:
                bw.write_uint(0, 1)
                bw.write_uint(1, 6)  # verbatim
                bw.write_uint(0, 1)
                bw.write_sints_vec(ch, bps)
        body += bw.getvalue()
    body += struct.pack(">H", _crc16(bytes(body)))
    return bytes(body)


def encode_flac(samples: np.ndarray, n_channels: int, rate: int,
                bit_depth: int = 16, mode: str = "verbatim") -> bytes:
    """Encode interleaved float32 samples to a FLAC stream.

    mode="verbatim" (default) is the fast uncompressed path used for the HLS
    piggyback payload; mode="fixed" uses an order-2 fixed predictor with
    rice residuals (smaller, slower — also exercises the residual decoder).
    """
    if bit_depth not in (16, 24):  # what the PCM quantizer supports
        raise FlacError("unsupported FLAC bit depth %d" % bit_depth)
    if not 1 <= n_channels <= 8:
        raise FlacError("unsupported FLAC channel count %d" % n_channels)
    pcm = _int_samples(samples, bit_depth).reshape(-1, n_channels)
    n_frames = pcm.shape[0]
    # MD5 over the little-endian PCM bytes, per spec
    from .wavfile import encode_samples
    md5 = hashlib.md5(encode_samples(np.asarray(samples, dtype=np.float32),
                                     bit_depth, Encoding.SIGNED)).digest()
    total = n_frames
    si = bytearray()
    si += struct.pack(">HH", _BLOCK, _BLOCK)
    si += b"\x00\x00\x00" * 2  # min/max frame size unknown
    si.append((rate >> 12) & 0xFF)
    si.append((rate >> 4) & 0xFF)
    si.append(((rate & 0xF) << 4) | ((n_channels - 1) << 1) |
              ((bit_depth - 1) >> 4))
    si.append((((bit_depth - 1) & 0xF) << 4) | ((total >> 32) & 0xF))
    si += struct.pack(">I", total & 0xFFFFFFFF)
    si += md5
    out = bytearray(b"fLaC")
    out.append(0x80)  # last metadata block, type 0 = STREAMINFO
    out += len(si).to_bytes(3, "big")
    out += si
    for idx, start in enumerate(range(0, max(n_frames, 1), _BLOCK)):
        frame = pcm[start:start + _BLOCK]
        if frame.shape[0] == 0:
            break
        out += _encode_frame(frame, idx, rate, bit_depth, mode)
    return bytes(out)


# ---- stream integration ------------------------------------------------------

def _read_stream_info(f) -> dict:
    """Parse the fLaC marker + metadata blocks from a file object, leaving
    it positioned at the first audio frame."""
    if f.read(4) != b"fLaC":
        raise FlacError("not a FLAC stream")
    info = None
    while True:
        hdr = f.read(4)
        if len(hdr) < 4:
            raise FlacError("truncated metadata")
        length = int.from_bytes(hdr[1:4], "big")
        body = f.read(length)
        if len(body) < length:
            raise FlacError("truncated metadata")
        if (hdr[0] & 0x7F) == 0:  # STREAMINFO
            si = body[:34]
            if len(si) < 34:
                raise FlacError("short STREAMINFO")
            rate = (si[10] << 12) | (si[11] << 4) | (si[12] >> 4)
            n_channels = ((si[12] >> 1) & 0x7) + 1
            bps = (((si[12] & 1) << 4) | (si[13] >> 4)) + 1
            total = (((si[13] & 0x0F) << 32) |
                     int.from_bytes(si[14:18], "big"))
            info = {"rate": rate, "channels": n_channels, "bps": bps,
                    "total": total}
        if hdr[0] & 0x80:
            break
    if info is None:
        raise FlacError("missing STREAMINFO")
    return info


class _StreamingFrameReader:
    """Incremental frame decoder over a sliding byte window.

    Frames are byte-aligned back to back, so after each decoded frame the
    consumed prefix is dropped and the window refilled — memory stays
    bounded by the window size regardless of file length (the reference
    streams FLAC through libsndfile read_frames the same way,
    src/sfinputstream.cc:189-210).  A frame truncated by the window edge
    raises inside the bit reader; the window refills and retries, and only
    an error with no new bytes available is real.
    """

    REFILL = 4 << 20        # bytes appended per refill

    def __init__(self, f, info: dict):
        self.f = f
        self.info = info
        self.buf = b""
        self.br = None
        self.eof = False

    def _refill(self) -> bool:
        data = self.f.read(self.REFILL)
        if not data:
            self.eof = True
            return False
        if self.br is not None:
            byte_pos = self.br.pos // 8
            self.buf = self.buf[byte_pos:] + data
        else:
            self.buf = self.buf + data
        self.br = _BitReader(self.buf)
        return True

    def _slide(self):
        if self.br is not None and self.br.pos // 8 > (self.REFILL >> 1):
            byte_pos = self.br.pos // 8
            self.buf = self.buf[byte_pos:]
            self.br = _BitReader(self.buf)

    def next_frame(self) -> Optional[np.ndarray]:
        if self.br is None and not self._refill():
            return None
        while True:
            save_pos = self.br.pos
            try:
                frame = _decode_frame(self.br, self.info)
            except FlacError:
                self.br.pos = save_pos
                if self.eof or not self._refill():
                    raise
                continue
            if frame is None and not self.eof:
                # near the window edge; try with more data
                self.br.pos = save_pos
                if self._refill():
                    continue
            if frame is not None:
                self._slide()
            return frame


class FlacInputStream(AudioInputStream):
    """FLAC file input, decoded incrementally with bounded memory
    (SFInputStream FLAC analog, src/sfinputstream.cc:189-210)."""

    def __init__(self, filename: str):
        from .streams import StreamError
        try:
            self._f = open(filename, "rb")
        except OSError as e:
            raise StreamError("error opening FLAC input: %s" % e)
        try:
            info = _read_stream_info(self._f)
        except FlacError as e:
            self._f.close()
            raise StreamError("error decoding FLAC input: %s" % e)
        self._info = info
        self._reader = _StreamingFrameReader(self._f, info)
        self._n_channels = info["channels"]
        self._rate = info["rate"]
        self._bps = info["bps"]
        self._scale = np.float32(1.0 / (1 << (self._bps - 1)))
        self._total = info["total"] or None
        self._emitted = 0
        self._pending = np.zeros(0, dtype=np.float32)

    def bit_depth(self) -> int:
        return self._bps

    def sample_rate(self) -> int:
        return self._rate

    def n_channels(self) -> int:
        return self._n_channels

    def n_frames(self):
        return self._total

    def encoding(self):
        return Encoding.SIGNED

    def read_frames(self, count: int) -> np.ndarray:
        from .streams import StreamError
        want = count * self._n_channels
        chunks = [self._pending]
        have = self._pending.size
        while have < want:
            if self._total is not None \
                    and self._emitted + have // self._n_channels \
                    >= self._total:
                break
            try:
                frame = self._reader.next_frame()
            except FlacError as e:
                raise StreamError("error decoding FLAC input: %s" % e)
            if frame is None:
                break
            block = (frame.astype(np.float32) * self._scale).reshape(-1)
            chunks.append(block)
            have += block.size
        buf = np.concatenate(chunks) if len(chunks) > 1 else chunks[0]
        if self._total is not None:
            remaining = (self._total - self._emitted) * self._n_channels
            if buf.size > remaining:
                buf = buf[:remaining]
        out, self._pending = buf[:want], buf[want:]
        self._emitted += out.size // self._n_channels
        return out

    def close(self):
        self._f.close()
