"""Port key-derived state (audiowmark_tpu_torch tables.py, ops/sync.py,
ops/frames.py windows, models/common.py) vs the JAX package, exact.

The system has no weights: its state is the layout the key derives.  Every
array the port derives, and every tensor tables_to_device makes of it, must
equal the JAX package's bit for bit, for several keys and geometries.
Each package reads its own Params (the geometry is set on both) and gets
its own Key made from the same test key."""

import numpy as np
import pytest
import torch

from audiowmark_tpu import tables as jtables
from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models.common import build_ab_frame_mods as j_mods
from audiowmark_tpu.ops import frames as jframes
from audiowmark_tpu.ops import sync as jsync
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import tables as ttables
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.models.common import build_ab_frame_mods as t_mods
from audiowmark_tpu_torch.models.common import parse_payload

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _reset_params():
    JParams.reset()
    TParams.reset()
    yield
    JParams.reset()
    TParams.reset()


def _key(cls, test_key):
    key = cls()
    if test_key is not None:
        key.set_test_key(test_key)
    return key


GEOMETRIES = {
    "default": {},
    "reduced": {"sync_frames_per_bit": 30, "frames_per_bit": 1},
    "short16_linear": {"payload_short": True, "payload_size": 16,
                       "mix": False},
}


@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
@pytest.mark.parametrize("test_key", [None, 1, 7, 42])
def test_key_tables_and_device_tensors_match_jax(test_key, geometry):
    for name, value in GEOMETRIES[geometry].items():
        setattr(JParams, name, value)
        setattr(TParams, name, value)
    jt = jtables.get_key_tables(_key(JKey, test_key))
    tt = ttables.get_key_tables(_key(TKey, test_key))
    assert (tt.n_data_frames, tt.n_sync_frames) == \
        (jt.n_data_frames, jt.n_sync_frames)
    assert ttables.frames_per_block() == jtables.frames_per_block()

    dev = ttables.tables_to_device(tt, "cpu")
    for name in ttables.TABLE_FIELDS:
        want = getattr(jt, name)
        assert np.array_equal(getattr(tt, name), want), name
        assert dev[name].dtype == torch.from_numpy(want).dtype, name
        assert np.array_equal(dev[name].numpy(), want), name
    for mode, clip in (("block", False), ("clip", True)):
        jsb = jsync._build_sync_bits(jt, clip)
        assert np.array_equal(dev["sync_frame_" + mode].numpy(), jsb.frame)
        assert np.array_equal(dev["sync_v_" + mode].numpy(), jsb.v)
    assert np.array_equal(dev["analysis_window"].numpy(),
                          jframes.analysis_window())
    assert np.array_equal(dev["synthesis_window"].numpy(),
                          jframes.synthesis_window())

    bits = parse_payload("0123456789abcdef0011223344556677"[
        : TParams.payload_size // 4])
    assert np.array_equal(t_mods(tt, bits), j_mods(jt, bits))
