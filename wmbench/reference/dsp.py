"""Windows and spectra of the watermark, in plain torch.

Upstream audiowmark: the analysis window is a Hann window normalised to a
sum of 2 (src/wmcommon.cc:68-89); the synthesis window is a cosine-
flattened triangle over three frames with 10 % overlap
(src/wmadd.cc:169-250); a band's level is 10 log10 |X|^2 of the windowed
frame's FFT, -96 dB where the power is 0 (src/wmcommon.cc:123-141).
"""

from __future__ import annotations

import numpy as np
import torch

from .keyed import Geom
from .prec import Prec

MIN_DB = -96.0


def analysis_window(g: Geom) -> np.ndarray:
    n = g.frame_size
    x = (np.arange(n, dtype=np.float64) - n / 2.0) / (n / 2.0)
    win = np.where(np.abs(x) > 1, 0.0, 0.5 * np.cos(x * np.pi) + 0.5)
    return win * (2.0 / win.sum())


def synthesis_window(g: Geom) -> np.ndarray:
    n = g.frame_size
    pos = (np.arange(3 * n, dtype=np.float64) - n) / n
    pos = np.where(pos > 0.5, 1.0 - pos, pos)
    overlap = 0.1
    tri = np.where(pos < -overlap, 0.0,
                   np.where(pos < overlap, 0.5 + pos / (2 * overlap), 1.0))
    return (np.cos(tri * np.pi + np.pi) + 1.0) * 0.5


def window(g: Geom, which: str, prec: Prec, device) -> torch.Tensor:
    w = analysis_window(g) if which == "analysis" else synthesis_window(g)
    return prec.q(torch.from_numpy(w).to(device=device, dtype=prec.dtype))


def db_bands(frames: torch.Tensor, g: Geom, prec: Prec) -> torch.Tensor:
    """(..., frame_size) samples -> (..., n_bands) dB of the windowed
    spectrum over bands [min_band, max_band]."""
    awin = window(g, "analysis", prec, frames.device)
    spec = prec.q(torch.fft.rfft(prec.q(frames * awin), dim=-1))
    spec = spec[..., g.min_band:g.max_band + 1]
    p = prec.q(spec.real ** 2 + spec.imag ** 2)
    db = prec.q(10.0 * torch.log10(torch.where(p > 0, p, torch.ones_like(p))))
    return torch.where(p > 0, db, torch.full_like(db, MIN_DB))
