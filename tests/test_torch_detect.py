"""The port's fleet detector (ops/detect_fused.FusedDetector) vs the JAX
package's build_detector.

Mini geometry (as tests/test_detect_fused.py): short-12 payload, 10 sync
frames per bit, so a block is 852 + 60 = 912 frames and T = 1200 frames
cover block 0, which starts at frames_pad_start = 250.  The same seeded
numpy noise is marked once (by the JAX package's watermark_batch) and goes
through both detectors, the JAX one under jax.jit.

Tolerances: positions, block_is_a, bits and eligible are exact in every
slot, filler slots included; qualities rtol 2e-4 atol 2e-5 (f32 rfft vs the
band-DFT matmul, summed over 60 sync frames); errors atol 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from audiowmark_tpu import tables as j_tables
from audiowmark_tpu.codec.shortcode import short_encode_blk
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models.common import parse_payload
from audiowmark_tpu.ops.detect_fused import DetectorConfig as JConfig
from audiowmark_tpu.ops.detect_fused import build_detector as j_build
from audiowmark_tpu.parallel.batch import watermark_batch as j_watermark
from audiowmark_tpu.parallel.mesh import make_mesh as j_make_mesh
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import tables as t_tables
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.ops.detect_fused import (DetectorConfig,
                                                   FusedDetector,
                                                   build_detector)
from audiowmark_tpu_torch.ops.frames import FRAME
from audiowmark_tpu_torch.params import Params as TParams

torch.set_num_threads(2)
B, T, C, K = 3, 1200, 2, 4
PAYLOAD = "abc"
EXACT = ("positions", "block_is_a", "bits", "eligible")


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


@pytest.fixture(scope="module")
def marked():
    """(B, T*FRAME, C) marked noise; the last stream is noisier, so its
    later slots hold weaker candidates."""
    _mini()
    rng = np.random.RandomState(7)
    audio = (rng.rand(B, T * FRAME, C).astype(np.float32) - 0.5) * 0.6
    out = np.array(j_watermark(JKey(), audio, PAYLOAD,
                               mesh=j_make_mesh(4, dp=1)))
    out[-1] = np.clip(out[-1] + rng.randn(T * FRAME, C).astype(np.float32)
                      * 0.02, -1, 1)
    return out


@pytest.fixture(scope="module")
def jax_out(marked):
    _mini()
    det = jax.jit(jax.vmap(j_build(
        JKey(), JConfig(n_frames=T, n_channels=C, top_k=K))))
    return {k: np.asarray(v) for k, v in
            det(marked.reshape(B, -1)).items()}


def _detect(x, **cfg):
    det = build_detector(TKey(), DetectorConfig(n_frames=T, n_channels=C,
                                                **cfg), device="cpu")
    with torch.no_grad():
        return {k: v.numpy() for k, v in det(torch.from_numpy(x)).items()}


@pytest.fixture(scope="module")
def port_out(marked):
    _mini()
    return _detect(marked, top_k=K)


@pytest.mark.parametrize("name", EXACT)
def test_discrete_outputs_equal_jax_in_every_slot(jax_out, port_out, name):
    assert port_out[name].shape == jax_out[name].shape
    assert port_out[name].shape[:2] == (B, K)
    assert np.array_equal(port_out[name], jax_out[name])


def test_qualities_and_errors_match_jax(jax_out, port_out):
    np.testing.assert_allclose(port_out["qualities"], jax_out["qualities"],
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(port_out["errors"], jax_out["errors"],
                               atol=1e-4)
    assert port_out["qualities"].dtype == np.float32


def test_detector_recovers_codeword(port_out):
    codeword = list(short_encode_blk(parse_payload(PAYLOAD)))
    expect0 = TParams.frames_pad_start * FRAME
    for b in range(B):
        best = int(np.argmax(port_out["qualities"][b]))
        assert port_out["eligible"][b][best]
        assert abs(int(port_out["positions"][b][best]) - expect0) < FRAME // 2
        assert port_out["bits"][b][best].tolist() == codeword
        assert port_out["errors"][b][best] < 0.2


def test_batch_of_three_equals_three_single_calls(marked, port_out):
    for b in range(B):
        one = _detect(marked[b:b + 1], top_k=K)
        for name in port_out:
            assert np.array_equal(one[name][0], port_out[name][b]), name


def test_flat_and_shaped_input_agree(marked, port_out):
    flat = _detect(marked[:1].reshape(1, -1), top_k=K)
    for name in port_out:
        assert np.array_equal(flat[name][0], port_out[name][0]), name


def test_candidate_batch_does_not_change_results(marked, port_out):
    """The refine and the extraction in passes of 1 and of 3 candidates."""
    for cb in (1, 3):
        out = _detect(marked[:1], top_k=K, candidate_batch=cb)
        for name in EXACT:
            assert np.array_equal(out[name][0], port_out[name][0]), name
        np.testing.assert_allclose(out["qualities"][0],
                                   port_out["qualities"][0], rtol=1e-5)


def test_filler_slots_are_the_lowest_starts(marked):
    """Every slot past the eligible ones is a tie at score -1, and ties go
    to the lower start: a stream of digital silence gives the same slots,
    in the same order, as the JAX package's top_k."""
    x = np.zeros((1, T * FRAME, C), np.float32)
    _mini()
    det = jax.jit(j_build(JKey(), JConfig(n_frames=T, n_channels=C,
                                          top_k=K)))
    want = {k: np.asarray(v) for k, v in det(x[0].reshape(-1)).items()}
    got = _detect(x, top_k=K)
    assert np.array_equal(got["eligible"][0], want["eligible"])
    assert np.array_equal(got["positions"][0], want["positions"])


def test_without_cli_masking_matches_jax(marked):
    _mini()
    det = jax.jit(j_build(JKey(), JConfig(n_frames=T, n_channels=C, top_k=K,
                                          cli_masking=False)))
    want = {k: np.asarray(v) for k, v in
            det(marked[0].reshape(-1)).items()}
    got = _detect(marked[:1], top_k=K, cli_masking=False)
    for name in EXACT:
        assert np.array_equal(got[name][0], want[name]), name
    assert got["eligible"].all()


def test_detector_checks_its_input(marked):
    det = FusedDetector(TKey(), DetectorConfig(n_frames=T, n_channels=C,
                                               top_k=K), device="cpu")
    with pytest.raises(ValueError, match="samples must be"):
        det(torch.zeros(1, T * FRAME - 1, C))
    with pytest.raises(TypeError, match="float32"):
        det(torch.zeros(1, T * FRAME, C, dtype=torch.float64))
    with pytest.raises(ValueError, match="too short"):
        build_detector(TKey(), DetectorConfig(n_frames=900), device="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs no CUDA device")
def test_detector_without_a_card_raises():
    with pytest.raises(RuntimeError, match="CUDA"):
        build_detector(TKey(), DetectorConfig(n_frames=T))
