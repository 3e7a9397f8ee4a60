"""The shell's streams through the port's command line against the JAX
package's (the reference's pipe-test.sh, raw-format-test.sh and
wav-pipe-test.sh; tests/test_pipes_and_formats.py):

* the unknown-length add from stdin to stdout: raw PCM piped through
  `python -m audiowmark_tpu_torch add --input-format raw --output-format
  wav-pipe - -` (a process of its own on the CPU,
  AUDIOWMARK_TORCH_DEVICE=cpu; a plain WAV header needs the length, so
  both packages refuse it on stdout here) writes the samples the JAX
  package writes from the same raw file (<= 1 LSB, count printed), and
  the samples of the port's known-length streaming add of the same audio
  as WAV (`add --snr`): equal without the limiter, <= 1 LSB on < 1e-3 of
  them with it (the tiles ramp 16 -> 512 frames where the length is
  unknown, 4096 frames where it is known);
* raw PCM in and out in every encoding (signed 16/24/32, unsigned 8/16,
  float 32, double 64, big-endian, and the --raw-input-*/--raw-output-*
  forms), and WAV input of 8 (unsigned), 24 and 32-bit int and 32-bit
  float, and --output-format rf64: the exit code, stdout and the output's
  header equal the JAX package's, the samples <= 1 LSB apart at 8 and 16
  bits (count printed).  Both packages compute in float32 with their own
  FFTs, and at full scale their samples are up to 4 float32 steps
  (2^-22) apart, 2 LSB at 24 bits: deeper outputs are held to that, with
  the count of samples apart in 24-bit LSBs printed;
* `add --format raw` then `cmp --input-format raw` on both packages: the
  same stdout, and the port decodes its own 8-bit input's output with the
  same match count;
* slow, as the JAX package's own pipe tests: `add in.wav - | cmp -` and
  `add in.wav - | get -` as real pipes between the port's processes, and
  `add --output-format wav-pipe` (header sizes 0xFFFFFFFF) read back with
  `cmp --input-format wav-pipe`, the same stdout as the JAX package's cmp.

Every command runs with --strict.  The adds run at production geometry;
where a case decodes in-process, both packages' Params take the reduced
geometry of tests/test_torch_cli.py (30 sync frames per bit, 1 frame per
bit), at which the 80 s fixture holds blocks A, B, A and no clip decoder
runs.  The slow cases run at production geometry.  `pytest -rP` shows
the counts of samples apart.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiowmark_tpu import cli as j_cli
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu_torch import cli as t_cli
from audiowmark_tpu_torch.fixtures import raw_format, write_wav
from audiowmark_tpu_torch.io import wavfile
from audiowmark_tpu_torch.io.converters import RawConverter
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Encoding, Format, RawFormat
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.utils import log as t_log
from audiowmark_tpu.utils import log as j_log

torch.set_num_threads(2)
MSG = "0123456789abcdef0011223344556677"
SECONDS = 80
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = [sys.executable, "-m", "audiowmark_tpu_torch"]
ENV = dict(os.environ, AUDIOWMARK_TORCH_DEVICE="cpu", PYTHONPATH=REPO)
JAX = [sys.executable, "-m", "audiowmark_tpu"]
JAX_ENV = dict(os.environ, AUDIOWMARK_JAX_PLATFORM="cpu", PYTHONPATH=REPO)


@pytest.fixture(autouse=True)
def cpu_port(monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_TORCH_DEVICE", "cpu")
    yield
    JParams.reset()
    TParams.reset()
    j_log.set_log_level(j_log.Log.INFO)
    t_log.set_log_level(t_log.Log.INFO)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(directory, 80 s of 16-bit stereo noise as WAV, its samples as raw
    s16le)."""
    d = tmp_path_factory.mktemp("streams")
    wav = str(d / "n.wav")
    x = np.random.RandomState(8).uniform(-1, 1, SECONDS * 44100 * 2)
    WavData(x.astype(np.float32), 2, 44100, 16).save(wav)
    raw = str(d / "n.raw")
    with open(raw, "wb") as f:
        f.write(RawConverter(RawFormat()).to_raw(WavData.load(wav).samples))
    return d, wav, raw


def _run(cli, argv, capsys, reduced=False):
    """(exit code, stdout, stderr) of cli.main(argv), both packages' Params
    reset first (and at the reduced geometry where asked)."""
    for params in (JParams, TParams):
        params.reset()
        if reduced:
            params.sync_frames_per_bit = 30
            params.frames_per_bit = 1
    capsys.readouterr()
    rc = cli.main(list(argv))
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv_of, capsys, reduced=False):
    """argv_of(tag) through the JAX package's and the port's main; tag
    names each side's output files.  Both must exit alike and print the
    same stdout; returns the port's (rc, stdout, stderr)."""
    j = _run(j_cli, argv_of("jax"), capsys, reduced)
    t = _run(t_cli, argv_of("port"), capsys, reduced)
    assert (t[0], t[1]) == (j[0], j[1]), (j, t)
    return t


def _info(err):
    """The informational lines of an add, without the file names."""
    return [line for line in err.splitlines()
            if not line.startswith(("Input:", "Output:"))]


def _lsb_apart(a, b, step, what):
    """The samples a and b (float arrays) are at most one `step` apart;
    prints how many differ."""
    assert a.shape == b.shape, what
    diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
    n = int(np.count_nonzero(diff))
    print("%s: %d of %d samples apart, largest %.3g LSB of %s"
          % (what, n, a.size, diff.max() * 2.0 ** 15 if step >= 2.0 ** -15
             else diff.max() * 2.0 ** 23,
             "16 bits" if step >= 2.0 ** -15 else "24 bits"))
    assert diff.max() <= step * (1 + 1e-6), what
    return n


def _bound(encoding, bits):
    """The largest difference allowed at an output of `bits` bits: 1 LSB
    at 8 and 16 bits, 2 LSB of 24 bits (2^-22) deeper and for float."""
    return 2.0 ** -(bits - 1) if encoding != "float" and bits <= 16 \
        else 2.0 ** -22


def _raw_samples(path, fmt):
    with open(path, "rb") as f:
        return RawConverter(fmt).from_raw(f.read())


# ---- the unknown-length add, stdin -> stdout, a process of its own ----

@pytest.mark.parametrize("limiter", [True, False],
                         ids=["limiter", "no_limiter"])
def test_unknown_length_add_from_stdin_to_stdout(fixture, limiter, capsys):
    d, wav, raw = fixture
    opt = [] if limiter else ["--test-no-limiter"]
    argv = ["--strict", "add", "--input-format", "raw", "--raw-rate",
            "44100", "--output-format", "wav-pipe"] + opt
    with open(raw, "rb") as stdin:
        proc = subprocess.run(PORT + argv + ["-", "-", MSG], stdin=stdin,
                              capture_output=True, env=ENV, cwd=REPO,
                              timeout=600)
    assert proc.returncode == 0, proc.stderr.decode()
    assert proc.stdout[4:8] == b"\xff\xff\xff\xff"
    piped = str(d / ("piped_%d.wav" % limiter))
    with open(piped, "wb") as f:
        f.write(proc.stdout)
    TParams.reset()
    TParams.input_format = Format.WAV_PIPE
    got = WavData.load(piped).samples
    TParams.reset()

    j_out = str(d / ("jax_raw_%d.wav" % limiter))
    rc, out, err = _run(j_cli, argv + [raw, j_out, MSG], capsys)
    assert (rc, out) == (0, "")
    assert _info(proc.stderr.decode()) == _info(err)
    assert "Time:         unknown" in err
    _lsb_apart(got, WavData.load(j_out).samples, 2.0 ** -15,
               "stdin add vs the JAX package's raw add")

    known = str(d / ("known_%d.wav" % limiter))
    rc, _, _ = _run(t_cli, ["--strict", "add", "--snr"] + opt
                    + [wav, known, MSG], capsys)
    assert rc == 0
    want = WavData.load(known).samples
    n = _lsb_apart(got, want, 2.0 ** -15,
                   "unknown-length add vs the known-length streaming add")
    if limiter:
        assert n < 1e-3 * want.size
    else:
        assert n == 0


# ---- raw PCM in and out, every encoding ----

RAW_CASES = [  # (input (encoding, bits, endian), output (...))
    (("signed", 16, "little"),) * 2,
    (("signed", 16, "big"),) * 2,
    (("signed", 24, "little"),) * 2,
    (("signed", 32, "little"),) * 2,
    (("unsigned", 8, "little"),) * 2,
    (("unsigned", 16, "little"),) * 2,
    (("float", 32, "little"),) * 2,
    (("float", 64, "big"),) * 2,
    (("signed", 24, "big"), ("float", 32, "little")),
]


def _raw_options(fin, fout):
    """--raw-* options for one format, --raw-input-*/--raw-output-* for
    two; a float format is named by its encoding (float, double)."""
    opts = []
    sides = [("", fin)] if fin == fout else [("input-", fin),
                                             ("output-", fout)]
    for side, (enc, bits, endian) in sides:
        if enc == "float":
            opts += ["--raw-%sencoding" % side,
                     "double" if bits == 64 else "float"]
        else:
            opts += ["--raw-%sencoding" % side, enc,
                     "--raw-%sbits" % side, str(bits)]
        opts += ["--raw-%sendian" % side, endian]
    return opts


@pytest.mark.parametrize("fin,fout", RAW_CASES, ids=[
    "%s%d%s" % (a[0][0], a[1], a[2][0]) + (
        "" if a == b else "_to_%s%d%s" % (b[0][0], b[1], b[2][0]))
    for a, b in RAW_CASES])
def test_raw_encoding_add_matches_jax(fixture, fin, fout, capsys):
    d, wav, _ = fixture
    tag = "_".join(map(str, fin + fout))
    src = str(d / ("in_%s.raw" % tag))
    with open(src, "wb") as f:
        f.write(RawConverter(raw_format(*fin)).to_raw(
            WavData.load(wav).samples))
    outs = {k: str(d / ("out_%s_%s.raw" % (k, tag))) for k in ("jax", "port")}
    _both(lambda k: ["--strict", "add", "--format", "raw", "--raw-rate",
                     "44100"] + _raw_options(fin, fout)
          + [src, outs[k], MSG], capsys)
    assert os.path.getsize(outs["port"]) == os.path.getsize(outs["jax"]) \
        == os.path.getsize(src) * fout[1] // fin[1]
    got, want = (_raw_samples(outs[k], raw_format(*fout))
                 for k in ("port", "jax"))
    _lsb_apart(got, want, _bound(fout[0], fout[1]), "raw " + tag)


# ---- WAV input of every sample format, rf64 output ----

def _header(path):
    with open(path, "rb") as f:
        magic = f.read(4)
        f.seek(0)
        info = wavfile.parse_header(f)
    return magic, info.bit_depth, info.encoding, info.n_frames


WAV_CASES = [(8, Encoding.UNSIGNED, False), (24, Encoding.SIGNED, False),
             (32, Encoding.SIGNED, False), (32, Encoding.FLOAT, False),
             (16, Encoding.SIGNED, True)]


@pytest.mark.parametrize("bits,encoding,rf64", WAV_CASES, ids=[
    "u8", "s24", "s32", "f32", "rf64"])
def test_wav_format_add_matches_jax(fixture, bits, encoding, rf64, capsys):
    d, wav, _ = fixture
    tag = "%d_%s_%d" % (bits, encoding.name, rf64)
    src = str(d / ("in_%s.wav" % tag))
    write_wav(src, WavData.load(wav).samples, bits, encoding)
    outs = {k: str(d / ("out_%s_%s.wav" % (k, tag))) for k in ("jax", "port")}
    opt = ["--output-format", "rf64"] if rf64 else []
    _both(lambda k: ["--strict", "add"] + opt + [src, outs[k], MSG], capsys)
    got, want = (_header(outs[k]) for k in ("port", "jax"))
    assert got == want
    assert got[0] == (b"RF64" if rf64 else b"RIFF")
    # the output keeps the input's format (8 bits are written as 16)
    assert got[1:3] == ((16, Encoding.SIGNED) if bits == 8
                        else (bits, encoding))
    _lsb_apart(WavData.load(outs["port"]).samples,
               WavData.load(outs["jax"]).samples,
               _bound("float" if encoding == Encoding.FLOAT else "signed",
                      got[1]), "wav " + tag)


def test_port_decodes_its_8bit_output(fixture, capsys):
    """At the reduced geometry: the 8-bit input's marked file gives the
    16-bit file's match count (5 on the 80 s fixture, both packages)."""
    d, wav, _ = fixture
    src, out = str(d / "red_in8.wav"), str(d / "red_out8.wav")
    write_wav(src, WavData.load(wav).samples, 8, Encoding.UNSIGNED)
    assert _run(t_cli, ["--strict", "add", src, out, MSG], capsys,
                reduced=True)[0] == 0
    rc, text, _ = _run(t_cli, ["--strict", "cmp", out, MSG], capsys,
                       reduced=True)
    assert rc == 0 and "\nmatch_count 5 " in "\n" + text, text


# ---- raw in and out, then cmp of the raw file ----

def test_raw_round_trip_and_cmp_match_jax(fixture, capsys):
    d, _, raw = fixture
    outs = {k: str(d / ("rt_%s.raw" % k)) for k in ("jax", "port")}
    _both(lambda k: ["--strict", "add", "--format", "raw", "--raw-rate",
                     "44100", raw, outs[k], MSG], capsys, reduced=True)
    assert os.path.getsize(outs["port"]) == os.path.getsize(raw)
    _lsb_apart(*(_raw_samples(outs[k], raw_format("signed", 16, "little"))
                 for k in ("port", "jax")), 2.0 ** -15, "raw round trip")
    rc, text, _ = _both(lambda k: ["--strict", "cmp", "--input-format",
                                   "raw", "--raw-rate", "44100", outs[k],
                                   MSG], capsys, reduced=True)
    assert rc == 0 and "\nmatch_count 5 " in "\n" + text, text


# ---- real pipes between processes (slow, as the JAX package's) ----

@pytest.mark.slow
def test_pipe_add_to_cmp_and_get(fixture, capsys):
    """`add in.wav - MSG | cmp - MSG` and `add in.wav - MSG | get -` through
    the port's processes print what the JAX package's add and cmp/get of
    the file print."""
    d, wav, _ = fixture
    j_out = str(d / "pipe_jax.wav")
    assert _run(j_cli, ["--strict", "add", wav, j_out, MSG], capsys)[0] == 0
    for command in (["cmp", "-", MSG], ["get", "-"]):
        add = subprocess.Popen(PORT + ["--strict", "add", wav, "-", MSG],
                               stdout=subprocess.PIPE,
                               stderr=subprocess.DEVNULL, env=ENV, cwd=REPO)
        get = subprocess.run(PORT + ["--strict"] + command, stdin=add.stdout,
                             capture_output=True, env=ENV, cwd=REPO,
                             timeout=1200)
        add.stdout.close()
        assert add.wait(timeout=60) == 0
        want = _run(j_cli, ["--strict", command[0], j_out] + command[2:],
                    capsys)
        assert (get.returncode, get.stdout.decode()) == want[:2], \
            get.stderr.decode()
        assert want[0] == 0 and "match_count 0 " not in want[1]


@pytest.mark.slow
def test_wav_pipe_round_trip(fixture, capsys):
    """add --output-format wav-pipe to stdout (sizes 0xFFFFFFFF), then cmp
    --input-format wav-pipe: the port's stdout is the JAX package's."""
    d, wav, _ = fixture
    outs = {k: str(d / ("wp_%s.wav" % k)) for k in ("jax", "port")}
    for k, cmd, env in (("port", PORT, ENV), ("jax", JAX, JAX_ENV)):
        with open(outs[k], "wb") as f:
            proc = subprocess.run(
                cmd + ["--strict", "add", "--output-format", "wav-pipe", wav,
                       "-", MSG], stdout=f, stderr=subprocess.PIPE, env=env,
                cwd=REPO, timeout=600)
        assert proc.returncode == 0, proc.stderr.decode()
        with open(outs[k], "rb") as f:
            assert f.read(8)[4:] == b"\xff\xff\xff\xff"
    TParams.reset()
    TParams.input_format = Format.WAV_PIPE
    _lsb_apart(*(WavData.load(outs[k]).samples for k in ("port", "jax")),
               2.0 ** -15, "wav-pipe")
    rc, text, _ = _both(lambda k: ["--strict", "cmp", "--input-format",
                                   "wav-pipe", outs[k], MSG], capsys)
    assert rc == 0 and "match_count 0 " not in text, text
