"""Per-candidate raw soft-bit extraction (the block-decode core).

Port of audiowmark_tpu/ops/extract.py::block_raw_one, batched over
candidate block starts.  Reference semantics: the block dB spectrogram
(fft_range, src/wmcommon.cc:123-141), prev/next spectral background
subtraction with edge reflection + channel sum (src/wmget.cc:86-97), keyed
up/down band gathers and per-bit sums (mix_decode/linear_decode,
src/wmget.cc:67-152).
"""

from __future__ import annotations

import torch

from ..params import Params

from ..tables import KeyTables, tables_to_device
from .frames import FRAME, db_bands

# candidates per pass: bounds the (cands, count, C, FRAME) window stack
_BATCH = 4


def layout(tables: KeyTables, device):
    """The key's soft-bit layout for block_raw on `device`: (lay_frame,
    lay_up, lay_dn, group), the mix-scatter entries (bands relative to
    min_band, `group` entries per bit) or, with Params.mix off, the linear
    per-frame band tables (group 0)."""
    dev = tables_to_device(tables, device)
    if Params.mix:
        lay = (dev["mix_frame"], dev["mix_up"] - Params.min_band,
               dev["mix_dn"] - Params.min_band)
        group = Params.bands_per_frame * Params.frames_per_bit
    else:
        lay = (dev["pos_vec"][tables.n_sync_frames:],
               dev["data_up"] - Params.min_band,
               dev["data_dn"] - Params.min_band)
        group = 0
    return tuple(a.to(torch.int64) for a in lay) + (group,)


def block_raw(x: torch.Tensor, starts: torch.Tensor, awin: torch.Tensor,
              lay_frame: torch.Tensor, lay_up: torch.Tensor,
              lay_dn: torch.Tensor, count: int, mix: bool, group: int,
              fpb: int, batch: int = _BATCH) -> torch.Tensor:
    """Raw (pre-bit-order, pre-normalize) soft bits (K, n_coded) for block
    starts `starts` (K,) (per-channel sample indices) in x (n, C).

    mix mode:    lay_frame/lay_up/lay_dn are (n_data*30,) mix entries,
                 bands relative to min_band; `group` entries per bit.
    linear mode: lay_frame is (n_data_frames,), lay_up/lay_dn are
                 (n_data_frames, 30) band tables; `fpb` frames per bit.

    A start reading past the end is clamped to the last whole block, as
    dynamic_slice does in the JAX package; callers drop those candidates
    (index + count*FRAME <= frames, as the reference skips them).  The
    starts go through in passes of `batch`."""
    n, C = x.shape
    span = count * FRAME
    starts = torch.clamp(starts.to(torch.int64), 0, max(n - span, 0))
    ar = torch.arange(span, device=x.device)
    frames = torch.arange(count, device=x.device)
    nxt = frames + 1
    nxt[-1] = count - 2
    prv = frames - 1
    prv[0] = 1
    out = []
    for k0 in range(0, starts.shape[0], batch):
        idx = starts[k0:k0 + batch, None] + ar[None, :]      # (k, span)
        w = x[idx].reshape(-1, count, FRAME, C).transpose(2, 3)
        db = db_bands(w, awin)                              # (k, count, C, NB)
        # background subtraction with edge reflection + channel sum
        A = torch.sum(db - 0.5 * (db[:, prv] + db[:, nxt]), dim=2)
        if mix:
            u = A[:, lay_frame, lay_up]
            d = A[:, lay_frame, lay_dn]
            raw = torch.sum((u - d).reshape(A.shape[0], -1, group), dim=2)
        else:
            u = torch.sum(A[:, lay_frame[:, None], lay_up], dim=2)
            d = torch.sum(A[:, lay_frame[:, None], lay_dn], dim=2)
            raw = torch.sum((u - d).reshape(A.shape[0], -1, fpb), dim=2)
        out.append(raw)
    return torch.cat(out, dim=0)
