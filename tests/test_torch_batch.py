"""The port's fleet batch API (parallel/batch.py) vs the JAX package's on
its 8 host devices at a (2, 4) mesh.

Mini geometry (short-12 payload, 10 sync frames per bit, T = 1200 frames,
4 stereo streams of seeded numpy noise).

* ops/limiter.limit_blocks on a batch (watermark_batch's limiter) vs
  jax.jit of the JAX package's batch limiter on loud blocks and a trailing
  partial block: within 1 ulp and atol 1e-6, at most the counted samples
  apart; each row of a batch equal bit for bit to the row alone;
* watermark_batch: vs the JAX package's with the limiter on and off, with
  and without a tail past the last whole frame, atol 1e-5; a (2, 4) mesh
  of logical shards gives what one device gives, 0 apart;
* detect_batch on the port's own output finds the codeword in every stream,
  and equals the JAX package's detect_batch slot for slot (discrete outputs
  exact, qualities rtol 2e-4 atol 2e-5);
* without a card and without device="cpu" both raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiowmark_tpu import tables as j_tables
from audiowmark_tpu.codec.shortcode import short_encode_blk
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models.common import parse_payload
from audiowmark_tpu.parallel import batch as j_batch
from audiowmark_tpu.parallel.mesh import make_mesh as j_make_mesh
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import tables as t_tables
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.ops.frames import FRAME
from audiowmark_tpu_torch.ops.limiter import limit_blocks
from audiowmark_tpu_torch.parallel import batch as t_batch
from audiowmark_tpu_torch.parallel.mesh import make_mesh
from audiowmark_tpu_torch.params import Params as TParams

torch.set_num_threads(2)
B, T, C = 4, 1200, 2
PAYLOAD = "abc"


def _mini():
    for params in (JParams, TParams):
        params.reset()
        params.payload_short = 12
        params.payload_size = 12
        params.sync_frames_per_bit = 10
    j_tables.clear_cache()
    t_tables._cache.clear()


@pytest.fixture(autouse=True)
def mini_geometry():
    _mini()
    yield
    JParams.reset()
    TParams.reset()
    j_tables.clear_cache()
    t_tables._cache.clear()


def _audio(tail=0, gain=0.6):
    rng = np.random.RandomState(7)
    return ((rng.rand(B, T * FRAME + tail, C).astype(np.float32) - 0.5)
            * gain)


@pytest.fixture(scope="module")
def marked():
    _mini()
    return t_batch.watermark_batch(TKey(), _audio(), PAYLOAD,
                                   mesh=make_mesh(8, dp=2, device="cpu"))


def _loud(n, rows=3):
    """Seeded stereo rows (rows, n, C) with loud blocks in row 1: gains
    well below 1."""
    rng = np.random.RandomState(n)
    x = (rng.rand(rows, n, C).astype(np.float32) - 0.5) * 1.6
    x[1, n // 2:] *= 2.0
    return x


# samples apart from the JAX package's jitted batch limiter: 613, 522 and
# 0 of 60000, 52920 and 1800 on the CPU (its ramp is s0 + (i/bs)*(s1 - s0),
# the port's the whole-file add's s0 + i*((s1 - s0)*(1/bs)), each fused
# and rounded once); the bound leaves 5 % above the count
@pytest.mark.parametrize("n,block,apart", [(10000, 4410, 644),
                                           (8820, 4410, 548),
                                           (300, 441, 0)])
def test_limit_blocks_on_a_batch_matches_jax(n, block, apart):
    x = _loud(n)
    jitted = jax.jit(j_batch._limiter_body, static_argnums=(1, 2))
    want = np.asarray(jitted(jnp.asarray(x), block, 0.99))
    got = limit_blocks(torch.from_numpy(x).reshape(3, -1), torch.tensor(0.99),
                       block, C).reshape(x.shape).numpy()
    assert got.shape == want.shape == x.shape
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # a gain 1 ulp apart moves a sample by at most 2 of its ulps
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2
    assert np.count_nonzero(got != want) <= apart
    assert np.abs(got).max() <= 0.99 + 1e-6 < np.abs(x).max()


def test_limit_blocks_limits_each_row_on_its_own():
    """Each row of a batch = limit_blocks on that row alone, bit for bit."""
    x = torch.from_numpy(_loud(10000) * 1.5).reshape(3, -1)
    got = limit_blocks(x, torch.tensor(0.99), 4410, C)
    for row in range(3):
        alone = limit_blocks(x[row], torch.tensor(0.99), 4410, C)
        assert torch.equal(got[row], alone), row


@pytest.mark.parametrize("limiter,tail,gain", [(True, 0, 0.6),
                                               (False, 0, 0.6),
                                               (True, 700, 2.2),
                                               (False, 700, 0.6)])
def test_watermark_batch_matches_jax(limiter, tail, gain):
    audio = _audio(tail, gain)
    want = j_batch.watermark_batch(JKey(), audio, PAYLOAD,
                                   mesh=j_make_mesh(8, dp=2),
                                   apply_limiter=limiter)
    got = t_batch.watermark_batch(TKey(), audio, PAYLOAD,
                                  mesh=make_mesh(8, dp=2, device="cpu"),
                                  apply_limiter=limiter)
    assert got.shape == want.shape == audio.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert np.abs(got - audio).max() > 1e-4
    if tail and not limiter:
        assert np.array_equal(got[:, T * FRAME:], audio[:, T * FRAME:])


def test_watermark_batch_sharded_equals_one_device(marked):
    one = t_batch.watermark_batch(TKey(), _audio(), PAYLOAD, device="cpu")
    assert np.array_equal(one, marked)


def test_watermark_batch_rejects_what_the_mesh_cannot_divide():
    with pytest.raises(AssertionError, match="must divide sp"):
        t_batch.watermark_batch(TKey(), _audio()[:, :1199 * FRAME], PAYLOAD,
                                mesh=make_mesh(8, dp=2, device="cpu"))
    with pytest.raises(AssertionError, match="must divide dp"):
        t_batch.watermark_batch(TKey(), _audio()[:3], PAYLOAD,
                                mesh=make_mesh(8, dp=2, device="cpu"))
    with pytest.raises(ValueError, match="cannot parse"):
        t_batch.watermark_batch(TKey(), _audio(), "xyz", device="cpu")


def test_detect_batch_finds_the_codeword_in_every_stream(marked):
    out = t_batch.detect_batch(TKey(), marked, top_k=4,
                               mesh=make_mesh(2, device="cpu"))
    codeword = list(short_encode_blk(parse_payload(PAYLOAD)))
    assert out["bits"].shape == (B, 4, len(codeword))
    for b in range(B):
        best = int(np.argmax(out["qualities"][b]))
        assert out["eligible"][b][best] and out["block_is_a"][b][best]
        assert abs(int(out["positions"][b][best])
                   - TParams.frames_pad_start * FRAME) < FRAME // 2
        assert out["bits"][b][best].tolist() == codeword, b


def test_detect_batch_matches_jax(marked):
    want = j_batch.detect_batch(JKey(), marked, mesh=j_make_mesh(4), top_k=4)
    got = t_batch.detect_batch(TKey(), marked, top_k=4, device="cpu")
    assert set(got) == set(want)
    for name in ("positions", "block_is_a", "bits", "eligible"):
        assert np.array_equal(got[name], want[name]), name
    np.testing.assert_allclose(got["qualities"], want["qualities"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(got["errors"], want["errors"], atol=1e-4)


def test_detect_batch_over_devices_equals_one(marked):
    """4 logical devices, one stream each = 1 device, four streams."""
    one = t_batch.detect_batch(TKey(), marked, top_k=4, device="cpu")
    four = t_batch.detect_batch(TKey(), marked, top_k=4,
                                mesh=make_mesh(4, device="cpu"))
    for name in one:
        assert np.array_equal(one[name], four[name]), name
    with pytest.raises(AssertionError, match="must divide"):
        t_batch.detect_batch(TKey(), marked, top_k=4,
                             mesh=make_mesh(3, dp=1, device="cpu"))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA device")
@pytest.mark.parametrize("call", ["watermark_batch", "detect_batch"])
def test_batch_api_without_a_card_raises(call):
    """No device named: the card, and no fallback to the CPU."""
    args = (TKey(), _audio()[:1]) + ((PAYLOAD,) if call == "watermark_batch"
                                     else ())
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(t_batch, call)(*args)
