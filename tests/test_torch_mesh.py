"""The port's device mesh and sharded batch embed (parallel/mesh.py) vs the
JAX package's on its 8 host devices.

* make_mesh gives the JAX package's (dp, sp) shapes for 1, 2, 4, 8 devices
  and for a given dp, and with four cards (a faked count) names cuda:0 ..
  cuda:3 where the JAX package puts jax.devices()[:4];
* the sharded embed equals the unsharded one for sp = 1, 2, 4 and dp = 1,
  2, 0 samples apart: every shard runs the same per-frame arithmetic, and
  the halo hands over the neighbour's very frame;
* against the JAX package's batch_embed_sharded at (2, 4): atol 1e-5 (two
  FFT libraries, float32, samples of magnitude <= 0.3);
* the first embed of a fresh process equals the next, bit for bit: the
  process's first call into MKL's vector math (torch.log here), split over
  several threads, once gave the main thread's share from another code
  path (device._set_up_vector_math).
On the CPU every mesh entry is the CPU: the shards are logical.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiowmark_tpu.parallel.mesh import batch_embed_sharded as j_embed
from audiowmark_tpu.parallel.mesh import make_mesh as j_make_mesh
from audiowmark_tpu_torch.ops.frames import FRAME, N_BINS
from audiowmark_tpu_torch.parallel.mesh import (Mesh, batch_embed_sharded,
                                                make_mesh)

torch.set_num_threads(2)
B, T, C = 4, 16, 2
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _inputs():
    rng = np.random.RandomState(5)
    frames = ((rng.rand(B, T, C, FRAME) - 0.5) * 0.6).astype(np.float32)
    mods = rng.randint(-1, 2, size=(B, T, N_BINS)).astype(np.int8)
    return frames, mods


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_make_mesh_shapes_match_jax(n):
    mesh = make_mesh(n, device="cpu")
    assert mesh.shape == j_make_mesh(n).devices.shape
    assert mesh.axis_names == ("dp", "sp")
    assert all(d == torch.device("cpu") for d in mesh.devices.reshape(-1))


@pytest.mark.parametrize("n,dp", [(8, 2), (8, 8), (4, 1), (6, 3)])
def test_make_mesh_with_dp(n, dp):
    assert make_mesh(n, dp=dp, device="cpu").shape == \
        j_make_mesh(n, dp=dp).devices.shape == (dp, n // dp)


def test_make_mesh_rejects_a_dp_that_does_not_divide():
    with pytest.raises(ValueError, match="does not divide"):
        make_mesh(4, dp=3, device="cpu")


def test_flat_mesh_is_one_axis():
    flat = make_mesh(8, device="cpu").flat()
    assert flat.shape == (8,) and flat.axis_names == ("streams",)


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("needs no CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()


@pytest.mark.parametrize("dp", [0, 2])
def test_make_mesh_of_four_cards_is_in_jax_order(monkeypatch, dp):
    """With four cards (a faked count), make_mesh() names cuda:0 .. cuda:3
    where the JAX package's make_mesh(dp=dp) puts jax.devices()[:4]:
    (4, 1), and (2, 2) with dp = 2."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.delenv("AUDIOWMARK_MULTICHIP", raising=False)
    want = j_make_mesh(4, dp=dp).devices
    got = make_mesh(dp=dp).devices
    assert got.shape == want.shape == ((4, 1) if dp == 0 else (2, 2))
    assert all(d.type == "cuda" for d in got.reshape(-1))
    assert [[d.index for d in row] for row in got] == \
        [[d.id for d in row] for row in want]


@pytest.mark.parametrize("dp,sp", [(1, 1), (1, 2), (1, 4), (2, 2), (2, 4),
                                   (4, 1)])
def test_sharded_embed_equals_unsharded(dp, sp):
    frames, mods = _inputs()
    f, m = torch.from_numpy(frames), torch.from_numpy(mods)
    want = batch_embed_sharded(make_mesh(1, device="cpu"), f, m, 0.01)
    got = batch_embed_sharded(make_mesh(dp * sp, dp=dp, device="cpu"), f, m,
                              0.01)
    assert got.shape == want.shape == (B, T, C, FRAME)
    assert torch.equal(got, want)
    assert float(torch.abs(want - f).max()) > 1e-4      # it did embed


# A process that imports the port and forks fresh children, none of which
# has called MKL's vector math yet; each embeds twice on 4 threads and exits
# 1 where the two differ.  Without device._set_up_vector_math 10-15 % of
# such children differed; the parent prints how many did.
_FIRST_EMBED = r"""
import os, sys
import numpy as np, torch
from audiowmark_tpu_torch.ops.frames import FRAME, N_BINS
from audiowmark_tpu_torch.parallel.mesh import batch_embed_sharded, make_mesh
rng = np.random.RandomState(5)
f = torch.from_numpy(((rng.rand(%d, %d, %d, FRAME) - 0.5) * 0.6)
                     .astype(np.float32))
m = torch.from_numpy(rng.randint(-1, 2, size=(f.shape[0], f.shape[1], N_BINS))
                     .astype(np.int8))
differ = 0
for _ in range(int(sys.argv[1])):
    pid = os.fork()
    if pid == 0:
        torch.set_num_threads(4)
        a, b = (batch_embed_sharded(make_mesh(1, device="cpu"), f, m, 0.01)
                for _ in range(2))
        os._exit(0 if torch.equal(a, b) else 1)
    differ += os.waitstatus_to_exitcode(os.waitpid(pid, 0)[1]) != 0
print(differ)
""" % (B, T, C)


def test_first_embed_of_a_process_equals_the_next():
    """In 100 fresh processes the first embed equals the second, bit for
    bit (the fault behind an unsteady test_sharded_embed_equals_unsharded:
    at 10-15 % a child, 100 children all equal by chance ~3e-5)."""
    proc = subprocess.run(
        [sys.executable, "-c", _FIRST_EMBED, "100"], cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split() == ["0"]


def test_sharded_embed_has_no_wrap_around():
    """The first frame of a stream gets nothing from the last, and the
    other way round: each equals the embed of the stream alone."""
    frames, mods = _inputs()
    f, m = torch.from_numpy(frames), torch.from_numpy(mods)
    whole = batch_embed_sharded(make_mesh(4, dp=1, device="cpu"), f, m, 0.01)
    head = batch_embed_sharded(make_mesh(1, device="cpu"), f[:, :4],
                               m[:, :4], 0.01)
    assert torch.equal(whole[:, :3], head[:, :3])


def test_sharded_embed_matches_jax():
    frames, mods = _inputs()
    want = np.asarray(j_embed(j_make_mesh(8, dp=2), jnp.asarray(frames),
                              jnp.asarray(mods), 0.01))
    got = batch_embed_sharded(make_mesh(8, dp=2, device="cpu"),
                              torch.from_numpy(frames),
                              torch.from_numpy(mods), 0.01).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_embed_rejects_shapes_that_do_not_divide():
    frames, mods = _inputs()
    with pytest.raises(ValueError, match="must divide"):
        batch_embed_sharded(make_mesh(3, dp=1, device="cpu"),
                            torch.from_numpy(frames), torch.from_numpy(mods),
                            0.01)


def test_mesh_may_name_a_device_twice():
    devs = np.empty((1, 2), dtype=object)
    devs[0, 0] = devs[0, 1] = torch.device("cpu")
    frames, mods = _inputs()
    f, m = torch.from_numpy(frames), torch.from_numpy(mods)
    assert torch.equal(
        batch_embed_sharded(Mesh(devs), f, m, 0.01),
        batch_embed_sharded(make_mesh(1, device="cpu"), f, m, 0.01))
