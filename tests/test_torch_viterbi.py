"""Port Viterbi (audiowmark_tpu_torch ops/viterbi.py, codec/) vs the JAX
package on the same numpy inputs.

The plain PyTorch trellis must equal the Pallas kernel (interpret mode) and
the lax.scan form exactly: decisions (bit-packed by the port, unpacked to
the JAX package's int8 form here), final metrics and traced-back bits.
The port's decoders must give the JAX decoders' bits exactly and their
errors to rtol 1e-6 (one f32 division of the same metric; the branch
metrics come from another matmul, whose sums may round differently).
The CUDA kernel itself is compared with the plain version on the card in
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiowmark_tpu.codec import convcode as jconv
from audiowmark_tpu.codec import shortcode as jshort
from audiowmark_tpu.ops.viterbi_pallas import (viterbi_acs_pallas,
                                               viterbi_acs_pallas_batch)
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import device as tdevice
from audiowmark_tpu_torch.codec import convcode as tconv
from audiowmark_tpu_torch.codec import shortcode as tshort
from audiowmark_tpu_torch.fixtures import acs_check_metrics, acs_equal
from audiowmark_tpu_torch.models.decoder import normalize_soft_bits
from audiowmark_tpu_torch.ops import viterbi
from audiowmark_tpu_torch.params import Params as TParams

torch.set_num_threads(2)
S = viterbi.STATE_COUNT


@pytest.fixture(autouse=True)
def _reset_params():
    JParams.reset()
    TParams.reset()
    yield
    JParams.reset()
    TParams.reset()


def _bm(seed, B, steps):
    return np.random.RandomState(seed).rand(B, steps, S).astype(np.float32)


@pytest.mark.parametrize("B,steps", [(3, 9), (1, 12)])
def test_plain_acs_matches_pallas(B, steps):
    bm = _bm(B + steps, B, steps)
    dec_bits, metrics, _ = viterbi.viterbi_acs(torch.from_numpy(bm))
    dec = viterbi.unpack_decisions(dec_bits)
    if B == 1:
        jd, jm = viterbi_acs_pallas(jnp.asarray(bm[0]), interpret=True)
        jd, jm = np.asarray(jd)[None], np.asarray(jm)[None]
    else:
        jd, jm = viterbi_acs_pallas_batch(jnp.asarray(bm), interpret=True)
    assert np.array_equal(dec.numpy(), np.asarray(jd))
    assert np.array_equal(metrics.numpy(), np.asarray(jm).reshape(B, S))


def test_plain_acs_matches_pallas_on_ties_and_nan():
    """The rows chip_smoke.py and tests/test_torch_cuda.py hold K1 to:
    clean codewords (integer metrics, exact ties), an all-NaN row and a
    random row.  Decisions exact, metrics exact with NaN equal to NaN."""
    bm = acs_check_metrics(2, 5, 17, "cpu")
    dec = viterbi.unpack_decisions(viterbi.viterbi_acs_plain(bm)[0])
    metrics = viterbi.viterbi_acs(bm)[1]
    jd, jm = viterbi_acs_pallas_batch(jnp.asarray(bm.numpy()),
                                      interpret=True)
    assert np.array_equal(dec.numpy(), np.asarray(jd))
    assert np.array_equal(metrics.numpy(), np.asarray(jm).reshape(5, S),
                          equal_nan=True)
    assert np.isnan(metrics[3].numpy()).all()


def test_acs_check_helpers():
    """acs_check_metrics falls back to seeded random rows where no codeword
    or NaN row fits, and acs_equal takes NaN = NaN but no other change."""
    small = acs_check_metrics(4, 3, 17, "cpu")
    assert torch.equal(small, torch.from_numpy(_bm(4, 3, 17)))
    short = acs_check_metrics(4, 5, 9, "cpu")
    assert short.shape == (5, 9, S) and not torch.isnan(short).any()
    out = viterbi.viterbi_acs_plain(acs_check_metrics(2, 5, 17, "cpu"))
    assert torch.isnan(out[1]).any()
    assert acs_equal(out, tuple(t.clone() for t in out))
    for i in range(3):
        changed = [t.clone() for t in out]
        changed[i].view(-1)[-1] += 1
        assert not acs_equal(out, changed)
    changed = [t.clone() for t in out]
    changed[1][3, 0] = 0.0              # a NaN metric made finite
    assert not acs_equal(out, changed)


def test_plain_acs_matches_scan_and_traceback():
    B, steps = 3, 20
    bm = _bm(5, B, steps)
    _, metrics, bits = viterbi.viterbi_acs(torch.from_numpy(bm))
    n_coded = jnp.full((B,), 6.0 * steps, jnp.float32)
    jbits, jerr = jconv._trellis_from_bm(jnp.asarray(bm), n_coded)
    assert np.array_equal(bits.numpy(), np.asarray(jbits))
    assert np.array_equal(metrics[:, 0].numpy() / np.float32(6 * steps),
                          np.asarray(jerr))


def _codec_inputs(bt):
    """The tests/test_codec.py round-trip inputs for one block type."""
    out = []
    rng = np.random.RandomState(7)
    out.append(jconv.conv_encode(bt, rng.randint(0, 2, 128))
               .astype(np.float32))
    rng = np.random.RandomState(42)
    coded = jconv.conv_encode(bt, rng.randint(0, 2, 128)).astype(np.float32)
    pos = rng.choice(coded.size, int(coded.size * 0.12), replace=False)
    coded[pos] = 1.0 - coded[pos]
    out.append(coded)
    rng = np.random.RandomState(3)
    coded = jconv.conv_encode(bt, rng.randint(0, 2, 128)).astype(np.float32)
    out.append(np.clip(coded + rng.normal(0, 0.35, coded.shape), -1, 2)
               .astype(np.float32))
    return out


@pytest.mark.parametrize("bt", list(jconv.ConvBlockType))
def test_conv_decode_soft_matches_jax(bt):
    tbt = tconv.ConvBlockType(bt.value)
    for coded in _codec_inputs(bt):
        jb, je = jconv.conv_decode_soft(bt, coded, return_error=True)
        tb, te = tconv.conv_decode_soft(tbt, coded, return_error=True,
                                        device="cpu")
        assert np.array_equal(tb, jb)
        np.testing.assert_allclose(te, je, rtol=1e-6)


def test_conv_decode_soft_batch_matches_jax():
    rng = np.random.RandomState(11)
    batch = []
    for _ in range(3):
        coded = jconv.conv_encode(jconv.ConvBlockType.a,
                                  rng.randint(0, 2, 128)).astype(np.float32)
        pos = rng.choice(coded.size, 40, replace=False)
        coded[pos] = 1 - coded[pos]
        batch.append(coded)
    batch = np.stack(batch)
    jb, je = jconv.conv_decode_soft_batch(jconv.ConvBlockType.a, batch)
    tb, te = tconv.conv_decode_soft_batch(tconv.ConvBlockType.a, batch,
                                          device="cpu")
    assert np.array_equal(tb, jb)
    np.testing.assert_allclose(te, je, rtol=1e-6)


def test_conv_decode_soft_mixed_matches_jax():
    """a/b/ab rows (and an empty group) in one trellis; a NaN row, as
    normalize_soft_bits gives for all-zero soft bits, must decide like
    jnp.where(hi < lo, ...)."""
    rng = np.random.RandomState(13)
    groups = []
    for bt, n in ((jconv.ConvBlockType.a, 3), (jconv.ConvBlockType.b, 0),
                  (jconv.ConvBlockType.b, 2), (jconv.ConvBlockType.ab, 2)):
        rows = []
        for _ in range(n):
            coded = jconv.conv_encode(bt, rng.randint(0, 2, 128)) \
                .astype(np.float32)
            rows.append(np.clip(coded + rng.normal(0, 0.4, coded.shape),
                                -1, 2).astype(np.float32))
        n_coded = jconv.conv_code_size(bt, 128)
        groups.append((bt, np.stack(rows) if rows
                       else np.zeros((0, n_coded), np.float32)))
    with np.errstate(invalid="ignore"):
        nan_row = normalize_soft_bits(np.zeros(groups[3][1].shape[1],
                                               np.float32))
    assert np.isnan(nan_row).all()
    groups[3] = (groups[3][0], np.concatenate([groups[3][1], nan_row[None]]))

    jout = jconv.conv_decode_soft_mixed(groups)
    tout = tconv.conv_decode_soft_mixed(
        [(tconv.ConvBlockType(bt.value), c) for bt, c in groups],
        device="cpu")
    assert len(tout) == len(jout)
    for (tb, te), (jb, je) in zip(tout, jout):
        assert tb.shape == jb.shape
        assert np.array_equal(tb, jb)
        np.testing.assert_allclose(te, je, rtol=1e-6)
    assert np.isnan(tout[3][1][-1]) and np.isnan(jout[3][1][-1])


@pytest.mark.parametrize("bt", list(jconv.ConvBlockType))
def test_branch_metrics_match_jax_bit_for_bit(bt):
    """batch_branch_metrics equals the JAX package's _batch_branch_metrics
    bit for bit on noise-like soft bits: the same matmul order and the
    squares summed left to right as jnp.sum does (torch.sum's order left
    1.2 M of 4.7 M metrics a bit apart, enough to flip near-ties)."""
    table = tconv._state_output_table(tconv.ConvBlockType(bt.value))
    soft = np.random.RandomState(bt.value).rand(
        5, 143 * table.shape[1]).astype(np.float32)
    want = np.asarray(jconv._batch_branch_metrics(
        jnp.asarray(soft), jnp.asarray(np.broadcast_to(table,
                                                       (5,) + table.shape))))
    got = tconv.batch_branch_metrics(torch.from_numpy(soft),
                                     torch.from_numpy(table))
    assert np.array_equal(got.numpy(), want)


def test_forward_branch_metrics_in_one_buffer_equal_the_cat(monkeypatch):
    """ViterbiDecoder.forward writes each group's branch metrics into one
    preallocated (sum B_i, steps, STATE_COUNT) tensor; that tensor equals,
    bit for bit, the torch.cat of each group's metrics made apart."""
    rng = np.random.RandomState(5)
    groups = [(bt, torch.from_numpy(rng.rand(n, 30 * len(
        tconv.get_block_type_generators(bt))).astype(np.float32)))
        for bt, n in ((tconv.ConvBlockType.a, 3), (tconv.ConvBlockType.b, 2),
                      (tconv.ConvBlockType.ab, 2))]
    dec = tconv.viterbi_decoder("cpu")
    want = [tconv.batch_branch_metrics(c, dec.table(bt)) for bt, c in groups]
    seen = []
    acs = tconv.viterbi_acs
    monkeypatch.setattr(tconv, "viterbi_acs",
                        lambda bm: seen.append(bm.clone()) or acs(bm))
    bits, errs = dec(groups)
    assert len(seen) == 1 and seen[0].shape == (7, 30, S)
    assert torch.equal(seen[0], torch.cat(want))
    assert bits.shape == (7, 30) and errs.shape == (7,)


@pytest.mark.parametrize("k", [12, 16, 20])
def test_short_decode_matches_jax(k):
    for params in (JParams, TParams):
        params.payload_short = True
        params.payload_size = k
    assert jshort.short_code_init(k) > 0
    rng = np.random.RandomState(k)
    bits = rng.randint(0, 2, k)
    coded = jshort.short_encode(jconv.ConvBlockType.a, bits) \
        .astype(np.float32)
    assert np.array_equal(tshort.short_encode(tconv.ConvBlockType.a, bits),
                          coded)
    pos = rng.choice(coded.size, int(coded.size * 0.10), replace=False)
    coded[pos] = 1 - coded[pos]
    jb, je = jshort.short_decode_soft(jconv.ConvBlockType.a, coded, True)
    tb, te = tshort.short_decode_soft(tconv.ConvBlockType.a, coded, True,
                                      device="cpu")
    assert np.array_equal(tb, jb) and np.array_equal(tb, bits)
    np.testing.assert_allclose(te, je, rtol=1e-6)


@pytest.mark.parametrize("k", [12, 16, 20])
def test_short_decode_blk_matches_jax(k):
    """The exact codeword match on a codeword (its message) and on that
    codeword with one bit flipped (no codeword: empty), against the JAX
    package's exhaustive search; the port builds its table once per k."""
    for params in (JParams, TParams):
        params.payload_short = True
        params.payload_size = k
    assert jshort.short_code_init(k) > 0
    bits = np.random.RandomState(k).randint(0, 2, k)
    word = jshort.short_encode_blk(bits)
    bad = word.copy()
    bad[k % word.size] ^= 1
    for row, want in ((word, bits), (bad, np.empty(0, np.int32))):
        got = tshort.short_decode_blk(row)
        assert np.array_equal(got, jshort.short_decode_blk(row))
        assert np.array_equal(got, want) and got.dtype == np.int32


def test_decision_packing_round_trips():
    """pack -> unpack gives each pair's decision on both successors, and
    bit k of word w is pair 32w + k, bit 31 included (negative words)."""
    rng = np.random.RandomState(9)
    d = torch.from_numpy(rng.rand(2, 3, S // 2) < 0.5)
    words = viterbi.pack_decisions(d)
    assert words.shape == (2, 3, viterbi.WORDS) and words.dtype == torch.int32
    assert (words < 0).any()
    unpacked = viterbi.unpack_decisions(words)
    assert unpacked.dtype == torch.int8 and unpacked.shape == (2, 3, S)
    assert torch.equal(unpacked[..., 0::2].bool(), d)
    assert torch.equal(unpacked[..., 1::2].bool(), d)
    assert torch.equal(viterbi.pack_decisions(unpacked[..., 0::2].bool()),
                       words)
    one = torch.zeros(S // 2, dtype=torch.bool)
    one[32 * 7 + 31] = True
    word = viterbi.pack_decisions(one)
    assert int(word[7]) == -2**31 and int(torch.count_nonzero(word)) == 1


def test_cluster_size_fills_the_card():
    """The larger of 8 and 4 CTAs per row that keeps B x C within the
    card's 132 SMs, else 2 (waves)."""
    sizes = {b: viterbi.cluster_size(b, 132) for b in (1, 8, 9, 16, 17, 33,
                                                       34, 52, 140)}
    assert sizes == {1: 8, 8: 8, 9: 8, 16: 8, 17: 4, 33: 4, 34: 2, 52: 2,
                     140: 2}


def test_wrapper_checks_its_input():
    with pytest.raises(ValueError):
        viterbi.viterbi_acs(torch.zeros(2, 3, 1024))
    with pytest.raises(TypeError):
        viterbi.viterbi_acs(torch.zeros(1, 2, S, dtype=torch.float64))
    with pytest.raises(ValueError):
        viterbi.viterbi_acs(torch.zeros(1, 2, S, device="meta"))


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdevice.resolve()
    assert tdevice.resolve("cpu") == torch.device("cpu")
