"""The port stands alone: audiowmark_tpu_torch and chip_smoke.py import
neither jax nor anything of the JAX package `audiowmark_tpu`, and the
port's copies of the JAX package's host modules (params, crypto, io,
utils) behave as the originals do.

* an AST walk of every module of the port and of chip_smoke.py finds no
  import of `jax`, `jaxlib` or `audiowmark_tpu` (the package or below it);
* in a fresh interpreter where importing those names fails, every module
  of the port imports and a short add -> get runs on the CPU;
* the copies against the originals: the same Params defaults, the same
  key file gives the same Random stream bytes and shuffles, and a WAV file
  written by one package loads bit-equal in the other.
"""

import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest

from audiowmark_tpu.crypto.keys import Key as JKey
from audiowmark_tpu.crypto.prng import Random as JRandom
from audiowmark_tpu.crypto.prng import Stream as JStream
from audiowmark_tpu.crypto.prng import shuffle_identity as j_shuffle
from audiowmark_tpu.io import streams as jstreams
from audiowmark_tpu.io.wavdata import WavData as JWavData
from audiowmark_tpu.params import Encoding as JEncoding
from audiowmark_tpu.params import Params as JParams
import audiowmark_tpu_torch
from audiowmark_tpu_torch.crypto.keys import Key as TKey
from audiowmark_tpu_torch.crypto.prng import Random as TRandom
from audiowmark_tpu_torch.crypto.prng import Stream as TStream
from audiowmark_tpu_torch.crypto.prng import shuffle_identity as t_shuffle
from audiowmark_tpu_torch.io import streams as tstreams
from audiowmark_tpu_torch.io.wavdata import WavData as TWavData
from audiowmark_tpu_torch.params import Encoding as TEncoding
from audiowmark_tpu_torch.params import Params as TParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "audiowmark_tpu_torch")
BLOCKED = ("jax", "jaxlib", "audiowmark_tpu")


@pytest.fixture(autouse=True)
def _reset_params():
    JParams.reset()
    TParams.reset()
    yield
    JParams.reset()
    TParams.reset()


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        paths += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(paths)


def _absolute_imports(path):
    """(line, module) of every absolute import in the file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module


def test_port_imports_neither_jax_nor_the_jax_package():
    paths = _sources()
    assert len(paths) > 30 and any(p.endswith("chip_smoke.py") for p in paths)
    bad = ["%s:%d imports %s" % (os.path.relpath(p, REPO), line, module)
           for p in paths for line, module in _absolute_imports(p)
           if module.split(".")[0] in BLOCKED]
    assert not bad, "\n".join(bad)


def test_ast_walk_sees_a_blocked_import(tmp_path):
    """The walk itself: both forms of import, and not the port's own."""
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\n"
                   "def f():\n    from audiowmark_tpu.params import Params\n"
                   "from audiowmark_tpu_torch.params import Params\n"
                   "from .params import Params\n")
    found = [m for _, m in _absolute_imports(str(src))
             if m.split(".")[0] in BLOCKED]
    assert found == ["jax.numpy", "audiowmark_tpu.params"]


_BLOCKED_RUN = r"""
import importlib, pkgutil, sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "audiowmark_tpu"):
            raise ImportError(name + " is blocked")
sys.meta_path.insert(0, _Block())
import numpy as np
import torch
torch.set_num_threads(2)
import audiowmark_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                                "audiowmark_tpu_torch.")]
for name in names:
    importlib.import_module(name)
from audiowmark_tpu_torch.crypto.keys import Key
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Params
Params.sync_frames_per_bit = 30
Params.frames_per_bit = 1
d = sys.argv[1]
rng = np.random.RandomState(3)
WavData(((rng.rand(30 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32), 2,
        44100, 16).save(d + "/n.wav")
assert port.add_watermark(Key(), d + "/n.wav", d + "/wm.wav", "cd" * 16,
                          device="cpu") == 0
assert port.get_watermark([Key()], d + "/wm.wav", "cd" * 16,
                          device="cpu") == 0
assert not [m for m in sys.modules if m.split(".")[0] in
            ("jax", "jaxlib", "audiowmark_tpu")]
print("MODULES %d" % len(names))
"""


def test_every_port_module_imports_and_runs_with_the_jax_package_blocked(
        tmp_path):
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN, str(tmp_path)],
                          capture_output=True, text=True, cwd=REPO,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "\nmatch_count " in proc.stdout, proc.stdout
    n = int(proc.stdout.split("MODULES ")[1].split()[0])
    assert n == len(list(pkgutil.walk_packages(
        audiowmark_tpu_torch.__path__, "audiowmark_tpu_torch.")))


def test_params_defaults_match():
    """Every setting of the JAX package's Params, and its snapshot, has
    the same default in the port's."""
    names = [n for n in vars(JParams) if not n.startswith("_")
             and not callable(getattr(JParams, n))
             and not isinstance(vars(JParams)[n], classmethod)]
    assert len(names) > 20
    for name in names:
        j, t = getattr(JParams, name), getattr(TParams, name)
        if hasattr(j, "sample_rate"):                 # RawFormat
            j, t = vars(j), vars(t)
            j = {k: getattr(v, "name", v) for k, v in j.items()}
            t = {k: getattr(v, "name", v) for k, v in t.items()}
        else:
            j, t = getattr(j, "name", j), getattr(t, "name", t)
        assert t == j, name
    assert vars(TParams.snapshot()) == vars(JParams.snapshot())


@pytest.mark.parametrize("test_key", [None, "file"])
def test_key_and_random_streams_match(tmp_path, test_key):
    """The default key, or one key file loaded by each package: the same
    AES key and name, the same Random bytes on every stream, the same
    shuffles."""
    keys = []
    for cls in (JKey, TKey):
        key = cls()
        if test_key == "file":
            path = tmp_path / "k.key"
            path.write_text("# a key file\nkey 0123456789abcdef0123456789abcdef"
                            "\nname \"the test key\"\n")
            key.load_key(str(path))
        keys.append(key)
    jk, tk = keys
    assert tk.aes_key() == jk.aes_key() and tk.name() == jk.name()
    for js, ts in zip(JStream, TStream):
        assert js.name == ts.name and js.value == ts.value
        jr, tr = JRandom(jk, 5, js), TRandom(tk, 5, ts)
        assert [tr() for _ in range(40)] == [jr() for _ in range(40)]
        assert np.array_equal(t_shuffle(tk, 9, ts, 300),
                              j_shuffle(jk, 9, js, 300))


@pytest.mark.parametrize("bits,encoding", [(16, "SIGNED"), (24, "SIGNED"),
                                           (32, "SIGNED"), (32, "FLOAT")])
def test_wav_written_by_one_package_loads_bit_equal_in_the_other(
        tmp_path, bits, encoding):
    """Each package writes a 3-channel file through its own output stream;
    both packages load the same samples from it."""
    rng = np.random.RandomState(bits)
    x = ((rng.rand(3 * 4410) * 2 - 1) * 0.9).astype(np.float32)
    for src, dst, streams, enc in ((JWavData, TWavData, jstreams, JEncoding),
                                   (TWavData, JWavData, tstreams, TEncoding)):
        path = str(tmp_path / ("%s_%d.wav" % (src.__module__, bits)))
        out = streams.create_output_stream(path, 3, 44100, bits,
                                           enc[encoding], x.size // 3)
        out.write_frames(x)
        out.close()
        got, want = dst.load(path), src.load(path)
        assert got.samples.dtype == want.samples.dtype == np.float32
        assert got.samples.size == x.size
        assert np.array_equal(got.samples, want.samples)
        assert (got.n_channels, got.sample_rate, got.bit_depth) == \
            (want.n_channels, want.sample_rate, want.bit_depth)


def _fake_ts(path, n_packets=4):
    """A minimal TS file: 188-byte packets that start with 'G'."""
    rng = np.random.RandomState(7)
    data = rng.randint(0, 256, size=n_packets * 188).astype(np.uint8)
    data[::188] = ord("G")
    with open(path, "wb") as f:
        f.write(data.tobytes())


@pytest.mark.parametrize("payload_len", [5, 176, 3000])
def test_mpegts_copy_writes_and_reads_what_the_original_does(tmp_path,
                                                             payload_len):
    """hls/mpegts.py is a copy: the same entries give the same bytes from
    either writer, and each reader reads the other's file."""
    from audiowmark_tpu.hls import mpegts as j_ts
    from audiowmark_tpu_torch.hls import mpegts as t_ts
    src = str(tmp_path / "in.ts")
    _fake_ts(src)
    payload = bytes(np.random.RandomState(payload_len).randint(
        0, 256, size=payload_len).astype(np.uint8))
    var_map = {"size": "1024", "start_pos": "99", "channel_layout": "stereo"}
    outs = []
    for mod in (j_ts, t_ts):
        writer = mod.TSWriter()
        writer.append_data("full.flac", payload)
        writer.append_vars("vars", var_map)
        out = str(tmp_path / (mod.__name__ + ".ts"))
        writer.process(src, out)
        outs.append(out)
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        assert a.read() == b.read()
    for mod, path in ((j_ts, outs[1]), (t_ts, outs[0])):
        reader = mod.TSReader()
        reader.load(path)
        assert [e.filename for e in reader.entries()] == ["full.flac", "vars"]
        assert reader.find("full.flac").data == payload
        assert reader.parse_vars("vars") == var_map
        assert reader.find("nothere") is None
    assert (t_ts.PACKET_SIZE, t_ts.HEADER_SIZE) == \
        (j_ts.PACKET_SIZE, j_ts.HEADER_SIZE)


def test_prof_copy_reports_what_the_original_does():
    """utils/prof.py is a copy: the same phases, entered the same way,
    give the same names, counts and order; off by default."""
    from audiowmark_tpu.utils import prof as j_prof
    from audiowmark_tpu_torch.utils import prof as t_prof
    reports = []
    for mod in (j_prof, t_prof):
        assert mod.enabled is False
        mod.reset()
        with mod.phase("off"):
            pass
        mod.enabled = True
        try:
            for name, n in (("get.load", 3), ("get.search_clip", 1)):
                for _ in range(n):
                    with mod.phase(name):
                        sum(range(20000 * n))
        finally:
            mod.enabled = False
        reports.append(mod.report())
        mod.reset()
    assert [(k, v["n"]) for k, v in reports[0].items()] == \
        [(k, v["n"]) for k, v in reports[1].items()]
    assert set(reports[1]) == {"get.load", "get.search_clip"}
    assert all(v["s"] >= 0 for v in reports[1].values())


def test_ast_walk_covers_the_new_modules():
    rel = {os.path.relpath(p, REPO) for p in _sources()}
    for want in ("audiowmark_tpu_torch/parallel/batch.py",
                 "audiowmark_tpu_torch/parallel/mesh.py",
                 "audiowmark_tpu_torch/hls/hls.py",
                 "audiowmark_tpu_torch/hls/mpegts.py",
                 "audiowmark_tpu_torch/video.py",
                 "audiowmark_tpu_torch/ops/detect_fused.py",
                 "audiowmark_tpu_torch/utils/prof.py"):
        assert want in rel, want
    with open(os.path.join(REPO, "videowmark-torch")) as f:
        script = f.read()
    assert "audiowmark_tpu.video" not in script and "jax" not in script.lower()
