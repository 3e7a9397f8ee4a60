"""The program as a service uses it: its settings from a configuration
file, its log quiet (`-q`), its key loaded from a key file."""

from __future__ import annotations

import gc
import os
from typing import Dict

# Params knobs a configuration sets; the geometry constants it must match
_KNOBS = ("frames_per_bit", "water_delta", "payload_size",
          "sync_frames_per_bit", "sync_threshold2", "get_n_best")
_FIXED = ("frame_size", "bands_per_frame", "min_band", "max_band",
          "sync_bits", "sync_search_step", "sync_search_fine",
          "frames_pad_start", "mark_sample_rate", "limiter_block_size_ms",
          "limiter_ceiling")


def configure(cfg: Dict):
    """Set the program's Params to the configuration's watermark; returns
    the Params class."""
    from audiowmark_tpu_torch.params import Params
    from audiowmark_tpu_torch.utils.log import Log, set_log_level

    wm = cfg["watermark"]
    Params.reset()
    for k in _FIXED:
        if k in wm and getattr(Params, k) != wm[k]:
            raise ValueError("the program's %s is %r, the configuration "
                             "states %r" % (k, getattr(Params, k), wm[k]))
    for k in _KNOBS:
        if k in wm:
            setattr(Params, k, wm[k])
    Params.mix = True
    Params.test_no_limiter = not wm.get("limiter", True)
    set_log_level(Log.WARNING)
    return Params


def load_key(tmpdir: str, key: bytes):
    from audiowmark_tpu_torch import Key

    from .pool import key_file
    k = Key()
    k.load_key(key_file(os.path.join(tmpdir, "wmbench.key"), key))
    return k


def release() -> None:
    """Drop what the program cached on the cards."""
    import torch

    from audiowmark_tpu_torch import tables
    tables.clear_cache()
    gc.collect()
    torch.cuda.empty_cache()
