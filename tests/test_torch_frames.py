"""Port add core (audiowmark_tpu_torch ops/frames.add_file_core) vs the JAX
package's ops/frames._add_file_core on ~40 stereo frames, and the port's
StreamingLimiter vs the JAX one.

The port takes float32 input only.  For 16-bit sources (in_i16) the JAX
side takes the int16 samples and dequantizes them on the device; the port
takes the same samples as k/32768 in float32, which is exact, so both
routes must agree as closely as the float32 ones.

float32 output: atol 1e-6 (rfft/irfft, exp and log run in other
libraries, so the delta differs in the last bits).  int16 output: at most
1 LSB apart, where those last bits move a sample across a quantization
step; the count of such samples is asserted small and reported."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiowmark_tpu import tables as jtables
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models.common import build_ab_frame_mods
from audiowmark_tpu.ops import frames as jframes
from audiowmark_tpu.ops.limiter import StreamingLimiter as JLimiter
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch.ops import frames as tframes
from audiowmark_tpu_torch.ops.limiter import StreamingLimiter as TLimiter
from audiowmark_tpu_torch.params import Params as TParams

torch.set_num_threads(2)
FRAME = tframes.FRAME
N_FRAMES, C = 40, 2
# at most this share of int16 samples may sit 1 LSB apart
MAX_LSB_SHARE = 1e-3


@pytest.fixture(autouse=True)
def _reset_params():
    JParams.reset()
    TParams.reset()
    yield
    JParams.reset()
    TParams.reset()


def _inputs(seed, in_i16):
    rng = np.random.RandomState(seed)
    n = N_FRAMES * FRAME * C
    if in_i16:
        x = (rng.randint(-30000, 30000, n)).astype(np.int16)
        # a loud stretch so the limiter has gain to take away
        x[n // 3: n // 3 + 4000] = 32767
    else:
        x = ((rng.rand(n) * 2 - 1) * 0.9).astype(np.float32)
        x[n // 3: n // 3 + 4000] = 1.2
    tables = jtables.get_key_tables(JKey())
    mods = build_ab_frame_mods(
        tables, np.array([1, 0] * 64, np.int32))[300:300 + N_FRAMES]
    return x, np.ascontiguousarray(mods)


@pytest.mark.parametrize("in_i16", [True, False])
@pytest.mark.parametrize("out_i16", [True, False])
@pytest.mark.parametrize("no_limiter", [True, False])
@pytest.mark.parametrize("block_size", [4096, 44100])
def test_add_core_matches_jax(in_i16, out_i16, no_limiter, block_size):
    x, mods = _inputs(block_size + 2 * in_i16 + out_i16, in_i16)
    n_out = x.size - 3 * C          # trailing partial frame is cut
    wd = JParams.water_delta
    assert TParams.water_delta == wd
    want = np.asarray(jframes._add_file_core(
        jnp.asarray(x), jnp.asarray(mods), jnp.float32(wd),
        jnp.asarray(jframes.analysis_window()),
        jnp.asarray(jframes.synthesis_window()),
        jnp.float32(JParams.limiter_ceiling), N_FRAMES, C, n_out,
        no_limiter, in_i16, out_i16, block_size))
    xf = x.astype(np.float32) * np.float32(1.0 / 32768.0) if in_i16 else x
    got = tframes.add_file_core(
        torch.from_numpy(xf), torch.from_numpy(mods), wd,
        torch.from_numpy(tframes.analysis_window()),
        torch.from_numpy(tframes.synthesis_window()), C, n_out, no_limiter,
        out_i16, block_size).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if out_i16:
        diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
        n_lsb = int(np.count_nonzero(diff))
        print("int16 samples 1 LSB apart: %d of %d" % (n_lsb, diff.size))
        assert diff.max() <= 1
        assert n_lsb <= MAX_LSB_SHARE * diff.size
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # the mark is really there: the output differs from the input
    assert not np.array_equal(got[:n_out].astype(np.float32),
                              x[:n_out].astype(np.float32))


def test_streaming_limiter_matches_jax():
    rng = np.random.RandomState(3)
    j = JLimiter(2, 8000, 1000, 0.99)
    t = TLimiter(2, 8000, 1000, 0.99)
    zeros = 8000 * 3 + 512
    assert t.skip(zeros) == j.skip(zeros)
    for n in (5000, 17000, 40000, 3):
        chunk = ((rng.rand(2 * n) * 2 - 1) * 1.5).astype(np.float32)
        assert np.array_equal(t.process(chunk), j.process(chunk))
    assert np.array_equal(t.flush(), j.flush())
