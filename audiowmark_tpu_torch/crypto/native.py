"""ctypes loader for the native AES core (native/libaeswm.so).

The numpy implementation in crypto/aes.py is always available and is the
test oracle; when the shared library has been built (`make -C native`) the
batched keystream and shuffle-table derivation run in C++.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

_lib = None
_tried = False


def _find_lib() -> Optional[str]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for cand in (os.path.join(here, "native", "libaeswm.so"),
                 os.environ.get("AESWM_LIB", "")):
        if cand and os.path.exists(cand):
            return cand
    return None


def get_lib():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    path = _find_lib()
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.aeswm_ecb_encrypt.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64]
        lib.aeswm_ctr_keystreams_u64.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_uint64)]
        lib.aeswm_shuffle_tables.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_uint64, ctypes.c_uint8, ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int32)]
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def ecb_encrypt(key: bytes, blocks: np.ndarray) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    out = np.empty_like(blocks)
    lib.aeswm_ecb_encrypt(key, blocks.tobytes(),
                          out.ctypes.data_as(ctypes.c_char_p),
                          blocks.shape[0])
    return out


def ctr_keystreams_u64(key: bytes, ivs: np.ndarray,
                       n_u64: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    ivs = np.ascontiguousarray(ivs, dtype=np.uint8)
    n_ivs = ivs.shape[0]
    out = np.empty((n_ivs, n_u64), dtype=np.uint64)
    lib.aeswm_ctr_keystreams_u64(
        key, ivs.tobytes(), n_ivs, n_u64,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def shuffle_tables(key: bytes, seeds: Sequence[int], stream: int,
                   n: int) -> Optional[np.ndarray]:
    lib = get_lib()
    if lib is None:
        return None
    seeds_arr = np.asarray(list(seeds), dtype=np.uint64)
    out = np.empty((len(seeds), n), dtype=np.int32)
    lib.aeswm_shuffle_tables(
        key, seeds_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        len(seeds), stream, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out
