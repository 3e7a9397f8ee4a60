"""Ogg/Vorbis input via ctypes libvorbisfile, plus a libvorbisenc encoder
for test fixtures and BER attacks.

The reference reads Ogg/Vorbis through libsndfile's SF_FORMAT_VORBIS path
(src/sfinputstream.cc:137-144: bit_depth 24, signed) and its robustness
harness encodes attacks with oggenc (src/ber-ogg.sh).  This image has the
vorbis libraries but no CLI tools, so both directions are bound directly.
"""

from __future__ import annotations

import ctypes
from ctypes import (POINTER, byref, c_char_p, c_double, c_float, c_int,
                    c_long, c_longlong, c_size_t, c_void_p)
from typing import Optional

import numpy as np

from .streams import AudioInputStream, StreamError

_libs = None
_load_failed = False


class _VorbisInfo(ctypes.Structure):
    _fields_ = [("version", c_int), ("channels", c_int), ("rate", c_long),
                ("bitrate_upper", c_long), ("bitrate_nominal", c_long),
                ("bitrate_lower", c_long), ("bitrate_window", c_long),
                ("codec_setup", c_void_p)]


class _OggPacket(ctypes.Structure):
    _fields_ = [("packet", c_void_p), ("bytes", c_long), ("b_o_s", c_long),
                ("e_o_s", c_long), ("granulepos", c_longlong),
                ("packetno", c_longlong)]


class _OggPage(ctypes.Structure):
    _fields_ = [("header", c_void_p), ("header_len", c_long),
                ("body", c_void_p), ("body_len", c_long)]


# opaque library-initialized state: over-allocated raw buffers
_VF_SIZE = 4096          # OggVorbis_File (~944 on x86-64)
_DSP_SIZE = 4096         # vorbis_dsp_state
_BLOCK_SIZE = 4096       # vorbis_block
_OSS_SIZE = 4096         # ogg_stream_state (~408)
_VC_SIZE = 256           # vorbis_comment
_VI_SIZE = 256           # vorbis_info


def _load():
    global _libs, _load_failed
    if _libs is not None or _load_failed:
        return _libs
    try:
        ogg = ctypes.CDLL("libogg.so.0")
        vorbis = ctypes.CDLL("libvorbis.so.0")
        venc = ctypes.CDLL("libvorbisenc.so.2")
        vfile = ctypes.CDLL("libvorbisfile.so.3")
    except OSError:
        _load_failed = True
        return None

    vfile.ov_fopen.argtypes = [c_char_p, c_void_p]
    vfile.ov_fopen.restype = c_int
    vfile.ov_info.argtypes = [c_void_p, c_int]
    vfile.ov_info.restype = POINTER(_VorbisInfo)
    vfile.ov_pcm_total.argtypes = [c_void_p, c_int]
    vfile.ov_pcm_total.restype = c_longlong
    vfile.ov_read_float.argtypes = [c_void_p,
                                    POINTER(POINTER(POINTER(c_float))),
                                    c_int, POINTER(c_int)]
    vfile.ov_read_float.restype = c_long
    vfile.ov_clear.argtypes = [c_void_p]

    vorbis.vorbis_info_init.argtypes = [c_void_p]
    vorbis.vorbis_info_clear.argtypes = [c_void_p]
    vorbis.vorbis_comment_init.argtypes = [c_void_p]
    vorbis.vorbis_comment_clear.argtypes = [c_void_p]
    vorbis.vorbis_analysis_init.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_block_init.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_analysis_headerout.argtypes = [c_void_p, c_void_p,
                                                 c_void_p, c_void_p,
                                                 c_void_p]
    vorbis.vorbis_analysis_buffer.argtypes = [c_void_p, c_int]
    vorbis.vorbis_analysis_buffer.restype = POINTER(POINTER(c_float))
    vorbis.vorbis_analysis_wrote.argtypes = [c_void_p, c_int]
    vorbis.vorbis_analysis_blockout.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_analysis.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_bitrate_addblock.argtypes = [c_void_p]
    vorbis.vorbis_bitrate_flushpacket.argtypes = [c_void_p, c_void_p]
    vorbis.vorbis_block_clear.argtypes = [c_void_p]
    vorbis.vorbis_dsp_clear.argtypes = [c_void_p]

    venc.vorbis_encode_init_vbr.argtypes = [c_void_p, c_long, c_long,
                                            c_float]
    venc.vorbis_encode_init.argtypes = [c_void_p, c_long, c_long, c_long,
                                        c_long, c_long]

    ogg.ogg_stream_init.argtypes = [c_void_p, c_int]
    ogg.ogg_stream_packetin.argtypes = [c_void_p, c_void_p]
    ogg.ogg_stream_flush.argtypes = [c_void_p, c_void_p]
    ogg.ogg_stream_pageout.argtypes = [c_void_p, c_void_p]
    ogg.ogg_stream_clear.argtypes = [c_void_p]

    _libs = (ogg, vorbis, venc, vfile)
    return _libs


def available() -> bool:
    return _load() is not None


def ogg_detect(filename: str) -> bool:
    """OggS capture-pattern sniff + a real header open via libvorbisfile."""
    try:
        with open(filename, "rb") as f:
            if f.read(4) != b"OggS":
                return False
    except OSError:
        return False
    libs = _load()
    if libs is None:
        return True   # looks like Ogg; the stream ctor reports the error
    _, _, _, vfile = libs
    vf = ctypes.create_string_buffer(_VF_SIZE)
    if vfile.ov_fopen(filename.encode(), vf) != 0:
        return False
    vfile.ov_clear(vf)
    return True


class OggVorbisInputStream(AudioInputStream):
    """Decode Ogg/Vorbis to float frames (bit_depth 24, signed — the
    reference's SF_FORMAT_VORBIS mapping, src/sfinputstream.cc:137-144)."""

    def __init__(self, filename: str):
        libs = _load()
        if libs is None:
            raise StreamError(
                "input looks like an Ogg file, but no Vorbis decoder is "
                "available (libvorbisfile not found)")
        if filename == "-":
            raise StreamError("Ogg input from stdin is not supported")
        self._vfile = libs[3]
        self._vf = ctypes.create_string_buffer(_VF_SIZE)
        rc = self._vfile.ov_fopen(filename.encode(), self._vf)
        if rc != 0:
            self._vf = None
            raise StreamError("cannot decode Ogg/Vorbis input (%d)" % rc)
        vi = self._vfile.ov_info(self._vf, -1).contents
        self._n_channels = int(vi.channels)
        self._sample_rate = int(vi.rate)
        total = self._vfile.ov_pcm_total(self._vf, -1)
        self._n_frames = int(total) if total >= 0 else None

    def bit_depth(self) -> int:
        return 24

    def sample_rate(self) -> int:
        return self._sample_rate

    def n_channels(self) -> int:
        return self._n_channels

    def n_frames(self) -> Optional[int]:
        return self._n_frames

    def read_frames(self, count: int) -> np.ndarray:
        C = self._n_channels
        out = np.empty((count, C), dtype=np.float32)
        got = 0
        bitstream = c_int(0)
        pcm = POINTER(POINTER(c_float))()
        while got < count:
            n = self._vfile.ov_read_float(self._vf, byref(pcm),
                                          count - got, byref(bitstream))
            if n == 0:
                break
            if n < 0:
                raise StreamError("Ogg/Vorbis decode error (%d)" % n)
            for c in range(C):
                out[got:got + n, c] = np.ctypeslib.as_array(
                    pcm[c], shape=(n,))
            got += n
        return np.ascontiguousarray(out[:got]).reshape(-1)

    def close(self):
        if self._vf is not None:
            self._vfile.ov_clear(self._vf)
            self._vf = None


def encode_vorbis(samples: np.ndarray, n_channels: int, sample_rate: int,
                  quality: float = 0.4,
                  bitrate_kbps: Optional[int] = None) -> bytes:
    """Encode interleaved float32 samples to an Ogg/Vorbis byte string.

    quality follows oggenc's -q scale (-0.1 .. 1.0 here as fraction);
    bitrate_kbps switches to managed-bitrate mode like `oggenc -b N`
    (reference attack: src/ber-ogg.sh uses oggenc -b 128).
    """
    libs = _load()
    if libs is None:
        raise RuntimeError("vorbis libraries are not available")
    ogg, vorbis, venc, _ = libs

    x = np.asarray(samples, dtype=np.float32).reshape(-1, n_channels)
    n_total = x.shape[0]

    vi = ctypes.create_string_buffer(_VI_SIZE)
    vorbis.vorbis_info_init(vi)
    if bitrate_kbps is not None:
        rc = venc.vorbis_encode_init(vi, n_channels, sample_rate,
                                     -1, bitrate_kbps * 1000, -1)
    else:
        rc = venc.vorbis_encode_init_vbr(vi, n_channels, sample_rate,
                                         c_float(quality))
    if rc != 0:
        vorbis.vorbis_info_clear(vi)
        raise RuntimeError("vorbis_encode_init failed (%d)" % rc)

    vc = ctypes.create_string_buffer(_VC_SIZE)
    vd = ctypes.create_string_buffer(_DSP_SIZE)
    vb = ctypes.create_string_buffer(_BLOCK_SIZE)
    os_ = ctypes.create_string_buffer(_OSS_SIZE)
    vorbis.vorbis_comment_init(vc)
    vorbis.vorbis_analysis_init(vd, vi)
    vorbis.vorbis_block_init(vd, vb)
    ogg.ogg_stream_init(os_, 1)

    out = bytearray()
    og = _OggPage()

    def pages(flush=False):
        fn = ogg.ogg_stream_flush if flush else ogg.ogg_stream_pageout
        while fn(os_, byref(og)):
            out.extend(ctypes.string_at(og.header, og.header_len))
            out.extend(ctypes.string_at(og.body, og.body_len))

    try:
        hdr = _OggPacket()
        hdr_comm = _OggPacket()
        hdr_code = _OggPacket()
        vorbis.vorbis_analysis_headerout(vd, vc, byref(hdr),
                                         byref(hdr_comm), byref(hdr_code))
        for p in (hdr, hdr_comm, hdr_code):
            ogg.ogg_stream_packetin(os_, byref(p))
        pages(flush=True)

        op = _OggPacket()
        CHUNK = 4096
        pos = 0
        while True:
            n = min(CHUNK, n_total - pos)
            if n > 0:
                buf = vorbis.vorbis_analysis_buffer(vd, n)
                for c in range(n_channels):
                    np.ctypeslib.as_array(buf[c], shape=(n,))[:] = \
                        x[pos:pos + n, c]
                pos += n
            vorbis.vorbis_analysis_wrote(vd, n)
            while vorbis.vorbis_analysis_blockout(vd, vb) == 1:
                vorbis.vorbis_analysis(vb, None)
                vorbis.vorbis_bitrate_addblock(vb)
                while vorbis.vorbis_bitrate_flushpacket(vd, byref(op)) == 1:
                    ogg.ogg_stream_packetin(os_, byref(op))
                    pages()
            if n == 0:
                break
        pages(flush=True)
        return bytes(out)
    finally:
        ogg.ogg_stream_clear(os_)
        vorbis.vorbis_block_clear(vb)
        vorbis.vorbis_dsp_clear(vd)
        vorbis.vorbis_comment_clear(vc)
        vorbis.vorbis_info_clear(vi)
