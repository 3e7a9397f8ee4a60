"""Short payload block codes (12/16/20 bits) over GF(2).

Port of audiowmark_tpu/codec/shortcode.py: BKLC(GF(2), N, K) generator
matrices; encode = GF(2) matmul then conv_encode of the codeword; decode =
Viterbi (ops/viterbi.py through codec/convcode.py) then an exhaustive
codeword match, returning an empty array when nothing matches exactly.
The generator for a payload of k bits is picked by k
(Params.payload_size), so the module holds no selected-matrix state.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Dict, List

import numpy as np

from ..params import Params

from ..device import DeviceLike
from .convcode import (ConvBlockType, conv_code_size, conv_decode_soft,
                       conv_encode)

_MATRICES: Dict[int, np.ndarray] = {}


def _register(k: int, n: int, rows: List[str]):
    mat = np.zeros((k, n), dtype=np.uint8)
    for i, row_hex in enumerate(rows):
        bits = np.unpackbits(np.frombuffer(bytes.fromhex(row_hex),
                                           dtype=np.uint8))
        mat[i] = bits[:n]
    _MATRICES[k] = mat


# BKLC(GF(2), 56, 12), d=22
_register(12, 56, [
    "8008d3626d1d7f", "400d8fef5b0ba0", "201172e4837516", "101431964963ce",
    "0811206d2f8a5b", "0408f0c45e86ea", "02010c52a5b79d", "010c680b3fb9fc",
    "0094b4f7171d2b", "00448629e9ccd6", "00389929ea3351", "0003fff83feff9",
])

# BKLC(GF(2), 61, 16), d=21
_register(16, 61, [
    "8000f2ebf2141920", "40007975f90a0c90", "20003cbafc850648",
    "100086d28be9f9c8", "0800dbe6b05f8608", "0400f57cad84b9e8",
    "0200e231a3692618", "0100e997241fe9e0", "008074cb920ff4f0",
    "00403a65c907fa78", "002085bd112887d0", "001042de889443e8",
    "0008b9e0b1e15b18", "0004c47fad5bd760", "0002623fd6adebb0",
    "0001311feb56f5d8",
])

# BKLC(GF(2), 65, 20), d=20
_register(20, 65, [
    "8000237f40ff5f3b80", "40002151a0f641df80", "20002046d0f2cead80",
    "100020cd68f0891480", "08002088b4f1aac800", "04000788da1c59d580",
    "02000799ad14112280", "010007911690355900", "008020b7cbbf459700",
    "0040079765bb2e7a00", "002020b4f22ac80680", "001022b479948a4100",
    "00080696bcaec99100", "000422341ea83bf300", "000204d68f38914800",
    "00012114076b179f80", "0000a2640334658d80", "000061dc0113dc8480",
    "000015cc806c8cb180", "00000cbb80247b9080",
])


def _matrix(k: int) -> np.ndarray:
    mat = _MATRICES.get(k)
    if mat is None:
        raise ValueError("unsupported short payload size %d" % k)
    return mat


def short_code_supported(k: int) -> bool:
    """Whether there is a generator matrix for payload size k."""
    return k in _MATRICES


def short_code_output_size(k: int) -> int:
    return _matrix(k).shape[1]


def short_encode_blk(in_bits) -> np.ndarray:
    bits = np.asarray(in_bits, dtype=np.uint8)
    mat = _matrix(bits.size)
    return ((bits[None, :] @ mat.astype(np.int32)) & 1).reshape(-1) \
        .astype(np.int32)


def short_encode(block_type: ConvBlockType, in_bits) -> np.ndarray:
    return conv_encode(block_type, short_encode_blk(in_bits))


def short_code_size(block_type: ConvBlockType, msg_size: int) -> int:
    return conv_code_size(block_type, _matrix(msg_size).shape[1])


@lru_cache(maxsize=None)
def _codeword_table(k: int):
    """All 2^k messages and their codewords, uint8, read-only, built once
    per payload size: numpy's int32 product of (2^k, k) by (k, n) takes
    ~2.7 s at k = 20, the comparison of one row with the table ~0.04 s."""
    mat = _matrix(k)
    # bit b of message c is (c >> b) & 1  (LSB-first, as the reference
    # iterates c & (1 << bit))
    msgs = ((np.arange(1 << k, dtype=np.uint32)[:, None]
             >> np.arange(k, dtype=np.uint32)[None, :]) & 1).astype(np.uint8)
    codewords = ((msgs.astype(np.int32) @ mat.astype(np.int32)) & 1) \
        .astype(np.uint8)
    msgs.flags.writeable = False
    codewords.flags.writeable = False
    return msgs, codewords


def short_decode_blk(coded_bits) -> np.ndarray:
    """Exhaustive exact-match decode; empty array when no codeword matches."""
    coded = np.asarray(coded_bits, dtype=np.uint8)
    msgs, codewords = _codeword_table(Params.payload_size)
    n = codewords.shape[1]
    match = np.all(codewords == coded[None, :n], axis=1)
    idx = np.nonzero(match)[0]
    if idx.size == 0:
        return np.empty(0, dtype=np.int32)
    return msgs[idx[0]].astype(np.int32)


def short_decode_soft(block_type: ConvBlockType, coded_bits,
                      return_error: bool = False, device: DeviceLike = None):
    inner, err = conv_decode_soft(block_type, coded_bits, return_error=True,
                                  device=device)
    if return_error:
        return short_decode_blk(inner), err
    return short_decode_blk(inner)
