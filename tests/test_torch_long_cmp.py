"""The 32-min `cmp` of chip_smoke.py's phase 13 on the CPU, both packages.

The fixture is `fixtures.long_noise(1, …)` (32 min of seeded stereo noise
at 44.1 kHz), marked by the port (the streaming add, as on the card).  Both
packages' `cmp` on that file, over two 30-min chunks at production
geometry, print the same pattern lines: time, bits and type equal, quality
and error within 0.002 (their printed 3 decimals), and the same
match_count line.  Every pattern above the sync threshold is the message.

Slow (not tier-1): tens of minutes of CPU for the two gets.

    python -m pytest tests/test_torch_long_cmp.py -m slow -s
"""

import time

import numpy as np
import pytest
import torch

from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.models.getter import get_watermark as j_get
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import add_watermark as t_add
from audiowmark_tpu_torch import get_watermark as t_get
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.fixtures import long_noise
from audiowmark_tpu_torch.params import Params as TParams

MSG = "0123456789abcdef0011223344556677"
MINUTES = 32


def _patterns(out):
    exact, floats = [], []
    for line in out.splitlines():
        f = line.split()
        if f and f[0] == "pattern":
            exact.append((f[1], f[2]) + tuple(f[5:]))
            floats.append((float(f[3]), float(f[4])))
    counts = [line for line in out.splitlines()
              if line.startswith("match_count")]
    return exact, np.array(floats), counts


@pytest.mark.slow
def test_32min_cmp_patterns_match_jax(tmp_path, capsys):
    torch.set_num_threads(4)
    JParams.reset()
    TParams.reset()
    noise, marked = str(tmp_path / "n.wav"), str(tmp_path / "wm.wav")
    long_noise(1, noise, MINUTES * 60, 44100)
    t0 = time.perf_counter()
    assert t_add(TKey(), noise, marked, MSG, device="cpu") == 0
    add_s = time.perf_counter() - t0
    capsys.readouterr()
    t0 = time.perf_counter()
    assert t_get([TKey()], marked, MSG, device="cpu") == 0
    port_s = time.perf_counter() - t0
    port = capsys.readouterr().out
    t0 = time.perf_counter()
    assert j_get([JKey()], marked, MSG) == 0
    jax_s = time.perf_counter() - t0
    jax = capsys.readouterr().out
    te, tf, tc = _patterns(port)
    je, jf, jc = _patterns(jax)
    with capsys.disabled():
        print("\n32-min cmp: port %d patterns, %d with the message; JAX %d, "
              "%d; %s; add %.1f s, port get %.1f s, JAX get %.1f s"
              % (len(te), sum(e[1] == MSG for e in te), len(je),
                 sum(e[1] == MSG for e in je), tc, add_s, port_s, jax_s))
    assert te == je
    np.testing.assert_allclose(tf, jf, rtol=0, atol=0.002)
    assert tc == jc
    above = [e for e, (q, _) in zip(te, tf) if q > TParams.sync_threshold2]
    assert above and all(e[1] == MSG for e in above)
