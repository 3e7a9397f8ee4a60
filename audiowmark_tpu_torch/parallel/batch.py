"""Fleet batch API: many streams per call.

Port of audiowmark_tpu/parallel/batch.py: `watermark_batch` embeds one
message into a batch of equal-length streams through the (dp, sp)-sharded
embed of parallel/mesh.py and a limiter vectorised over the batch;
`detect_batch` runs the fleet detector (ops/detect_fused.py) over a batch,
split over the mesh's devices with one detector each.  Streams are
independent, so throughput scales with the number of cards.  numpy in,
numpy out; `device=` or `mesh=` say where the work runs (default: every
CUDA card).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..crypto.keys import Key
from ..device import DeviceLike
from ..models.common import build_ab_frame_mods, parse_payload
from ..ops.detect_fused import DetectorConfig, build_detector
from ..ops.frames import FRAME
from ..params import Params
from ..tables import get_key_tables
from ..utils import prof
from .mesh import Mesh, batch_embed_sharded, make_mesh


def _limiter_body(x: torch.Tensor,
                  block_size: int = Params.mark_sample_rate,
                  ceiling: float = Params.limiter_ceiling) -> torch.Tensor:
    """Look-ahead limiter vectorised over (B, n_samples, C); the trailing
    partial block is zero-padded through, as the streamed reference does
    (src/limiter.cc)."""
    B, n, C = x.shape
    nb = -(-n // block_size)
    pad = nb * block_size - n
    if pad:
        x = torch.cat([x, x.new_zeros((B, pad, C))], dim=1)
    xb = x.reshape(B, nb, block_size * C)
    ceil = x.new_full((B, 1), ceiling)
    maxes = torch.clamp_min(torch.amax(torch.abs(xb), dim=2), ceiling)
    prev = torch.cat([ceil, maxes[:, :-1]], dim=1)
    nxt = torch.cat([maxes[:, 1:], ceil], dim=1)
    s0 = ceiling / torch.maximum(prev, maxes)
    s1 = ceiling / torch.maximum(maxes, nxt)
    ramp = torch.arange(block_size, dtype=torch.float32,
                        device=x.device) / block_size
    scale = s0[:, :, None] + ramp[None, None, :] * (s1 - s0)[:, :, None]
    out = xb.reshape(B, nb, block_size, C) * scale[..., None]
    return out.reshape(B, nb * block_size, C)[:, :n]


def watermark_batch(key: Key, audio: np.ndarray, message_hex: str,
                    mesh: Optional[Mesh] = None, apply_limiter: bool = True,
                    device: DeviceLike = None) -> np.ndarray:
    """Watermark a batch of equal-length streams.

    audio: (B, n_samples, C) float32 at the watermark rate (44.1 kHz).
    The whole frames are marked and the samples after the last whole frame
    pass through (to the limiter); the frame count must divide by the
    mesh's sp extent and B by its dp extent (pad beforehand if needed).
    Returns the watermarked batch with the same shape."""
    assert audio.ndim == 3
    if mesh is None:
        mesh = make_mesh(device=device)
    bitvec = parse_payload(message_hex)
    if bitvec is None:
        raise ValueError("cannot parse message %r" % message_hex)

    tables = get_key_tables(key)
    mods_ab = build_ab_frame_mods(tables, bitvec)

    B, n_samples, C = audio.shape
    T = n_samples // FRAME
    dp, sp = mesh.shape
    assert T % sp == 0, "frame count %d must divide sp=%d" % (T, sp)
    assert B % dp == 0, "batch %d must divide dp=%d" % (B, dp)

    audio = np.require(audio, np.float32, ["C", "W"])
    frames = torch.from_numpy(audio[:, : T * FRAME]).reshape(
        B, T, FRAME, C).transpose(2, 3)
    phases = (2 * tables.frames_per_block - Params.frames_pad_start
              + np.arange(T)) % mods_ab.shape[0]
    mods = torch.from_numpy(mods_ab[phases])[None].expand(B, -1, -1)

    marked = batch_embed_sharded(mesh, frames, mods, Params.water_delta)
    x = marked.transpose(2, 3).reshape(B, T * FRAME, C)
    if n_samples > T * FRAME:
        tail = torch.from_numpy(audio[:, T * FRAME:]).to(x.device)
        x = torch.cat([x, tail], dim=1)
    if apply_limiter:
        x = _limiter_body(x)
    return x.cpu().numpy()


def detect_batch(key: Key, audio: np.ndarray, mesh: Optional[Mesh] = None,
                 top_k: int = 8,
                 device: DeviceLike = None) -> Dict[str, np.ndarray]:
    """Fleet batch detection: the whole block-detect chain (spectrogram,
    score sweep, local mean, top-K, grid refine, block decode, batched
    Viterbi — ops/detect_fused.py) over a batch of equal-length streams,
    data-parallel over every device of the mesh.

    audio: (B, n_samples, C) float32 at 44.1 kHz; B must divide by the
    number of mesh devices.  Returns arrays with leading (B, top_k):
    positions (sample index), qualities, block_is_a, bits (payload),
    errors, and eligible (False marks filler slots past the CLI-eligible
    candidates)."""
    assert audio.ndim == 3
    if mesh is None:
        mesh = make_mesh(device=device)
    B, n_samples, C = audio.shape
    devices = mesh.flat().devices
    n_dev = devices.size
    assert B % n_dev == 0, "batch %d must divide %d devices" % (B, n_dev)

    T = n_samples // FRAME
    cfg = DetectorConfig(n_frames=T, n_channels=C, top_k=top_k)
    detectors = {}
    per = B // n_dev
    # every device's share is enqueued before any result is read
    outs = []
    for i, dev in enumerate(devices):
        if dev not in detectors:
            with prof.phase("fleet.build"):
                detectors[dev] = build_detector(key, cfg, dev)
        with prof.phase("fleet.upload"):
            share = np.require(audio[i * per:(i + 1) * per, : T * FRAME],
                               np.float32, ["C", "W"])
            x = torch.from_numpy(share).to(dev, non_blocking=True)
        with prof.phase("fleet.enqueue"), torch.no_grad():
            outs.append(detectors[dev](x))
    with prof.phase("fleet.readback"):
        return {k: np.concatenate([o[k].cpu().numpy() for o in outs])
                for k in outs[0]}
