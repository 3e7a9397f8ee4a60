"""Device meshes and the sharded batch embed.

Port of audiowmark_tpu/parallel/mesh.py.  The watermark has no dependency
between streams, so a batch decomposes over two axes:

* **dp** (data parallel): independent streams across devices, the
  throughput axis of the fleet API.
* **sp** (sequence parallel): the frame axis within a stream.  Frames are
  independent given the key tables except for the embedder's 3-frame
  overlap-add, which needs one delta frame from each neighbour shard: a
  1-frame halo copied device to device.

A `Mesh` is a (dp, sp) grid of `torch.device`s.  It may name one device
more than once: the shards are then logical, run one after another on that
device, and give the same samples as any other layout.  Every shard's work
is enqueued on its device before any result is read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve, spread
from ..ops.frames import (FRAME, _delta_iffts, analysis_window,
                          synthesis_window)


@dataclass
class Mesh:
    """A grid of devices with named axes; `devices` is an object ndarray of
    torch.device."""
    devices: np.ndarray
    axis_names: Tuple[str, ...] = ("dp", "sp")

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.devices.shape

    def flat(self, axis_name: str = "streams") -> "Mesh":
        """The same devices as one axis."""
        return Mesh(self.devices.reshape(-1), (axis_name,))


def _device_array(devs) -> np.ndarray:
    arr = np.empty(len(devs), dtype=object)
    for i, d in enumerate(devs):
        arr[i] = d
    return arr


def make_mesh(n_devices: int = 0, dp: int = 0,
              device: DeviceLike = None) -> Mesh:
    """A (dp, sp) mesh of n_devices devices (0: every card).  On CUDA they
    are the cards cuda:0 .. cuda:n-1; a request for more than there are
    cycles through them, and on the CPU every entry is the CPU (logical
    shards).  dp defaults to the largest power of two with dp*dp <= n that
    keeps n divisible."""
    n = n_devices or (torch.cuda.device_count()
                      if resolve(device).type == "cuda" else 1)
    devs = spread(device, n)
    if dp == 0:
        dp = 1
        while dp * dp <= n and n % (dp * 2) == 0:
            dp *= 2
    if n % dp:
        raise ValueError("dp=%d does not divide %d devices" % (dp, n))
    return Mesh(_device_array(devs).reshape(dp, n // dp))


def _embed_shard(frames: torch.Tensor, iffts: torch.Tensor,
                 right: torch.Tensor, left: torch.Tensor,
                 swin: torch.Tensor) -> torch.Tensor:
    """One shard's overlap-add: frames and their delta iffts (b, t, C,
    FRAME), `right` the left neighbour's last ifft frame and `left` the
    right neighbour's first, (b, C, FRAME) each, zero at the stream's two
    ends (no wrap-around)."""
    prv = torch.cat([right[:, None], iffts[:, :-1]], dim=1)
    nxt = torch.cat([iffts[:, 1:], left[:, None]], dim=1)
    return frames + (nxt * swin[:FRAME] + iffts * swin[FRAME:2 * FRAME]
                     + prv * swin[2 * FRAME:])


def batch_embed_sharded(mesh: Mesh, frames: torch.Tensor,
                        mods: torch.Tensor,
                        water_delta: float) -> torch.Tensor:
    """dp/sp-sharded batch embed: frames (B, T, C, FRAME) f32 and mods
    (B, T, N_BINS) int8 (on any device) -> the watermarked frames, same
    shape, on the mesh's first device.  B divides over dp and T over sp."""
    dp, sp = mesh.shape
    B, T, C, _ = frames.shape
    if B % dp or T % sp:
        raise ValueError("batch %d and frame count %d must divide the "
                         "(%d, %d) mesh" % (B, T, dp, sp))
    b, t = B // dp, T // sp

    # every shard's delta frames, each enqueued on its own device
    shards = {}
    for i in range(dp):
        for j in range(sp):
            dev = mesh.devices[i, j]
            f = frames[i * b:(i + 1) * b, j * t:(j + 1) * t].to(
                dev, non_blocking=True)
            m = mods[i * b:(i + 1) * b, j * t:(j + 1) * t].to(
                dev, non_blocking=True)
            awin = torch.from_numpy(analysis_window()).to(dev)
            iffts = _delta_iffts(f.reshape(b * t, C, FRAME),
                                 m.reshape(b * t, -1), water_delta,
                                 awin).reshape(b, t, C, FRAME)
            shards[i, j] = (f, iffts)

    # the halo, device to device, then the overlap-add
    out_dev = mesh.devices[0, 0]
    rows = []
    for i in range(dp):
        row = []
        for j in range(sp):
            f, iffts = shards[i, j]
            zero = iffts.new_zeros((b, C, FRAME))
            right = shards[i, j - 1][1][:, -1].to(iffts.device) \
                if j > 0 else zero
            left = shards[i, j + 1][1][:, 0].to(iffts.device) \
                if j < sp - 1 else zero
            swin = torch.from_numpy(synthesis_window()).to(iffts.device)
            row.append(_embed_shard(f, iffts, right, left, swin).to(out_dev))
        rows.append(torch.cat(row, dim=1))
    return torch.cat(rows, dim=0)
