"""The port's command line vs the JAX package's: the same argv through
`audiowmark_tpu.cli.main` and `audiowmark_tpu_torch.cli.main` gives the
same exit code and the same standard output (floats within their printed
digits where the devices' arithmetic differs), and the files written agree.

The port runs on the CPU here (AUDIOWMARK_TORCH_DEVICE=cpu); without that
setting and without a card its commands fail.  `main` sets class
attributes on Params and does not reset them, so every call here resets
both packages' Params first and sets the reduced geometry of
tests/test_torch_slice.py on both (30 sync frames per bit, 1 frame per
bit: 80 s hold blocks A, B, A; no clip decoder runs at that length).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from audiowmark_tpu import cli as j_cli
from audiowmark_tpu.params import Params as JParams
from audiowmark_tpu.utils import log as j_log
from audiowmark_tpu_torch import cli as t_cli
from audiowmark_tpu_torch.codec import convcode
from audiowmark_tpu_torch.io.wavdata import WavData
from audiowmark_tpu_torch.params import Params as TParams
from audiowmark_tpu_torch.utils import log as t_log

torch.set_num_threads(2)
MSG = "f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0f0"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def cpu_port(monkeypatch):
    monkeypatch.setenv("AUDIOWMARK_TORCH_DEVICE", "cpu")
    yield
    JParams.reset()
    TParams.reset()
    j_log.set_log_level(j_log.Log.INFO)     # --quiet lowers it for good
    t_log.set_log_level(t_log.Log.INFO)


def _run(cli, argv, capsys):
    """(exit code, stdout, stderr) of cli.main(argv) at the reduced
    geometry; a SystemExit counts as its code."""
    for params in (JParams, TParams):
        params.reset()
        params.sync_frames_per_bit = 30
        params.frames_per_bit = 1
    capsys.readouterr()
    try:
        rc = cli.main(list(argv))
    except SystemExit as e:
        rc = e.code
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys, port_argv=None):
    """argv through both mains; the codes and outputs, the JAX package's
    first."""
    j = _run(j_cli, argv, capsys)
    t = _run(t_cli, argv if port_argv is None else port_argv, capsys)
    return j, t


def _same_text(got, want, float_tol=0.0):
    """Line by line and word by word equal; words that are numbers with a
    decimal point may differ by float_tol."""
    g_lines, w_lines = got.splitlines(), want.splitlines()
    assert len(g_lines) == len(w_lines), (got, want)
    for g_line, w_line in zip(g_lines, w_lines):
        g_words, w_words = g_line.split(), w_line.split()
        assert len(g_words) == len(w_words), (g_line, w_line)
        for g, w in zip(g_words, w_words):
            if g != w:
                assert "." in g and "." in w, (g_line, w_line)
                assert abs(float(g) - float(w)) <= float_tol, (g_line, w_line)


def _assert_same(j, t, float_tol=0.0, stderr=True):
    assert t[0] == j[0], (j, t)
    _same_text(t[1], j[1], float_tol)
    if stderr:
        assert t[2] == j[2]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """80 s of seeded noise, marked by the port on the CPU, and that file
    played at speed 1.01."""
    os.environ["AUDIOWMARK_TORCH_DEVICE"] = "cpu"
    d = tmp_path_factory.mktemp("cli")
    paths = {k: str(d / (k + ".wav")) for k in ("noise", "marked", "fast")}
    rng = np.random.RandomState(7)
    WavData(((rng.rand(80 * 44100 * 2) * 2 - 1) * 0.5).astype(np.float32), 2,
            44100, 16).save(paths["noise"])
    for argv in (["add", paths["noise"], paths["marked"], MSG],
                 ["test-change-speed", paths["marked"], paths["fast"],
                  "1.01"]):
        TParams.reset()
        TParams.sync_frames_per_bit = 30
        TParams.frames_per_bit = 1
        assert t_cli.main(argv) == 0
    TParams.reset()
    del os.environ["AUDIOWMARK_TORCH_DEVICE"]
    return paths


# ---- commands that need no marked file ---------------------------------------

@pytest.mark.parametrize("argv", [
    ["--help"], ["-h"], ["--help-hls"], ["--version"],
    ["test-speed", "--test-key", "4", "42"],
    ["test-speed", "7"],
    ["test-speed", "--short", "16", "7"],
], ids=lambda a: "_".join(a))
def test_printing_commands_match_jax(argv, capsys):
    j, t = _both(argv, capsys)
    assert j[0] == 0 and j[1]
    _assert_same(j, t)


@pytest.mark.parametrize("argv", [
    ["--bogus", "get", "x.wav"],
    ["frobnicate"],
    [],
    ["get", "--no-such-option", "x.wav"],
    ["get"],
    ["cmp", "x.wav"],
    ["add", "a.wav", "b.wav"],
    ["get", "x.wav", "--short", "13"],
    ["get", "x.wav", "--short", "zz"],
    ["get", "x.wav", "--try-speed", "1.0.1"],
    ["get", "x.wav", "--detect-speed", "--try-speed", "1.01"],
    ["get", "x.wav", "--detect-speed", "--detect-speed-patient"],
    ["get", "x.wav", "--chunk-size", "5"],
    ["get", "x.wav", "--n-best", "-1"],
    ["add", "a.wav", "b.wav", MSG, "--input-format", "mp4"],
    ["add", "a.wav", "b.wav", MSG, "--input-format", "rf64"],
    ["add", "a.wav", "b.wav", MSG, "--raw-endian", "middle"],
    ["add", "a.wav", "b.wav", MSG, "--raw-encoding", "float", "--raw-bits",
     "16"],
    ["add", "a.wav", "b.wav", MSG, "--test-key", "1", "--test-key", "2"],
    ["gen-key"],
    ["get", "/nonexistent/x.wav"],
    ["cmp", "/nonexistent/x.wav", MSG],
    ["add", "/nonexistent/x.wav", "/nonexistent/y.wav", MSG],
    ["get", "/nonexistent/x.wav", "--key", "/nonexistent/k.key"],
], ids=lambda a: "_".join(a)[:60] or "no_args")
def test_bad_command_lines_fail_like_jax(argv, capsys):
    """Unknown options and commands, wrong positionals, bad option values
    and missing files: exit 1 with the JAX package's message on stderr
    (`audiowmark: error loading ...` for a missing file), no traceback."""
    j, t = _both(argv, capsys)
    assert j[0] == 1 and j[2].startswith("audiowmark: ")
    _assert_same(j, t)


def test_every_option_is_parsed_like_jax(capsys):
    """Every shared, add and get option of the JAX CLI in one add and one
    get command line on missing files: each side parses all of them (an
    unknown one would be `unsupported option`) and fails at the load."""
    add = ["add", "/nonexistent/a.raw", "/nonexistent/b.raw", "abcd",
           "--short", "16", "--frames-per-bit", "3", "--linear",
           "--set-input-label", "in", "--set-output-label", "out", "--snr",
           "--input-format", "raw", "--output-format", "raw", "--format=raw",
           "--raw-input-endian", "big", "--raw-output-endian", "little",
           "--raw-endian", "little", "--raw-input-encoding", "signed",
           "--raw-output-encoding", "unsigned", "--raw-encoding", "signed",
           "--raw-input-bits", "24", "--raw-output-bits", "32",
           "--raw-bits", "16", "--raw-channels", "1", "--raw-rate", "48000",
           "--test-no-limiter", "--strength", "12", "--test-key", "3",
           "--quiet", "--strict"]
    get = ["cmp", "/nonexistent/a.raw", "abcd", "--short=16",
           "--input-format", "raw", "--format", "raw",
           "--raw-input-endian", "big", "--raw-endian", "little",
           "--raw-input-encoding", "float", "--raw-encoding", "signed",
           "--raw-input-bits", "24", "--raw-bits", "16",
           "--raw-channels", "1", "--raw-rate", "48000", "--test-cut", "5",
           "--test-truncate", "9", "--hard", "--test-no-sync",
           "--try-speed", "1.01", "--test-speed", "1.01", "--json", "-",
           "--chunk-size", "12", "--sync-threshold", "0.3", "--n-best", "4",
           "--expect-matches", "2", "--test-key", "1", "--test-key", "2",
           "-q"]
    for argv in (add, get):
        j, t = _both(argv, capsys)
        assert j[0] == 1 and "error" in j[2] and "unsupported" not in j[2]
        _assert_same(j, t)
    assert (TParams.try_speed, TParams.get_n_best, TParams.hard,
            TParams.expect_matches, TParams.get_chunk_size) == \
        (1.01, 4, True, 2, 12.0)


@pytest.mark.parametrize("argv", [
    ["hls-add", "in.ts", "out.ts", MSG, "--bit-rate", "128000", "--short",
     "16", "--strength", "9", "--test-key", "2"],
    ["hls-prepare", "in", "out", "list.m3u8", "master.wav", "--bit-rate",
     "96000"],
])
def test_hls_commands_parse_and_raise(argv, capsys):
    """The hls commands parse their options and then run as the JAX
    package's do: on input that does not exist both report the same error
    and exit code (nothing raises); a wrong command line fails as any
    other."""
    j, t = _both(argv, capsys)
    assert j[0] == 1 and j[2]
    _assert_same(j, t)
    assert TParams.hls_bit_rate == int(argv[argv.index("--bit-rate") + 1])
    rc, _, err = _run(t_cli, [argv[0], "only-one"], capsys)
    assert rc == 1 and "error parsing arguments" in err


def test_gen_noise_and_info_match_jax(tmp_path, capsys):
    """test-gen-noise writes the same bytes from either package, at 16 and
    at 24 bits, with the default and a test key; test-info prints the same."""
    for i, extra in enumerate(([], ["--bits", "24", "--test-key", "5"])):
        a, b = str(tmp_path / ("j%d.wav" % i)), str(tmp_path / ("t%d.wav" % i))
        j = _run(j_cli, ["test-gen-noise", a, "0.5", "32000"] + extra, capsys)
        t = _run(t_cli, ["test-gen-noise", b, "0.5", "32000"] + extra, capsys)
        _assert_same(j, t)
        assert j[0] == 0
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        for prop in ("frames", "bit_depth", "colour"):
            j, t = _both(["test-info", b, prop], capsys)
            assert j[0] == (1 if prop == "colour" else 0)
            _assert_same(j, t)
    assert j_cli.main(["test-info", b, "bit_depth"]) == 0
    assert capsys.readouterr().out == "24\n"


def test_gen_key_matches_jax(tmp_path, capsys):
    """gen-key --name: the files agree but for the random key; each
    package loads the other's; a bad name or path fails alike."""
    a, b = str(tmp_path / "j.key"), str(tmp_path / "t.key")
    name = 'the "test" key'
    j = _run(j_cli, ["gen-key", a, "--name", name], capsys)
    t = _run(t_cli, ["gen-key", b, "--name", name], capsys)
    assert j[0] == 0
    _assert_same(j, t)
    la, lb = open(a).read().splitlines(), open(b).read().splitlines()
    assert len(la) == len(lb) == 4
    assert [la[0], la[1], la[3]] == [lb[0], lb[1], lb[3]]
    assert la[2] != lb[2] and len(la[2]) == len(lb[2]) == len("key ") + 32
    for argv in (["test-speed", "--key", a, "1"],
                 ["test-speed", "--key", b, "1"],
                 ["gen-key", str(tmp_path / "c.key"), "--name", "a\tb"],
                 ["gen-key", "/nonexistent/dir/c.key"]):
        j, t = _both(argv, capsys)
        _assert_same(j, t)


def test_wav_tools_match_jax(tmp_path, capsys):
    """cut-start, test-clip, test-subtract, test-snr, gentest (too short)
    on a 3 s noise file: the same codes, output and bytes."""
    n = str(tmp_path / "n.wav")
    assert _run(t_cli, ["test-gen-noise", n, "3", "44100"], capsys)[0] == 0

    def pair(argv_of):
        a = str(tmp_path / ("j_%s.wav" % argv_of("")[0]))
        b = str(tmp_path / ("t_%s.wav" % argv_of("")[0]))
        j = _run(j_cli, argv_of(a), capsys)
        t = _run(t_cli, argv_of(b), capsys)
        _assert_same(j, t)
        assert j[0] == 0
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read()
        return b

    cut = pair(lambda o: ["cut-start", n, o, "1000"])
    assert WavData.load(cut).n_frames == 3 * 44100 - 1000
    clip = pair(lambda o: ["test-clip", "--test-key", "2", n, o, "11", "1"])
    assert WavData.load(clip).n_frames == 44100
    sub = pair(lambda o: ["test-subtract", n, cut, o])
    assert WavData.load(sub).n_frames == 3 * 44100 - 1000
    quiet = str(tmp_path / "q.wav")
    w = WavData.load(n)
    WavData(w.samples * np.float32(0.5), 2, 44100, 16).save(quiet)
    j, t = _both(["test-snr", n, quiet], capsys)
    assert j[0] == 0 and abs(float(j[1]) - 6.02) < 0.01
    _assert_same(j, t)
    j, t = _both(["gentest", n, str(tmp_path / "g.wav")], capsys)
    assert j[0] == 1 and "too short" in j[2]
    _assert_same(j, t)


def test_resampling_commands_match_jax(tmp_path, capsys):
    """test-resample and test-change-speed: lengths exact, 16-bit samples
    at most 1 LSB apart on at most 2e-2 of them (the resampler's atol 1e-6
    across a rounding step of 3e-5, on full-scale noise).  Found on the
    CPU: 580 of 98000 at speed 0.9."""
    n = str(tmp_path / "n.wav")
    assert _run(t_cli, ["test-gen-noise", n, "1", "44100"], capsys)[0] == 0
    for cmd, arg, frames, rate in (("test-resample", "48000", 48000, 48000),
                                   ("test-change-speed", "0.9", 49000,
                                    44100)):
        a, b = str(tmp_path / "ja.wav"), str(tmp_path / "tb.wav")
        j = _run(j_cli, [cmd, n, a, arg], capsys)
        t = _run(t_cli, [cmd, n, b, arg], capsys)
        assert j[0] == 0
        _assert_same(j, t)
        wa, wb = WavData.load(a), WavData.load(b)
        assert wa.n_frames == wb.n_frames == frames
        assert wa.sample_rate == wb.sample_rate == rate
        lsb = np.abs(np.round((wa.samples.astype(np.float64) - wb.samples)
                              * 32768))
        print("%s: %d of %d samples 1 LSB apart"
              % (cmd, np.count_nonzero(lsb), lsb.size))
        assert lsb.max() <= 1 and np.count_nonzero(lsb) <= 2e-2 * lsb.size


def test_cli_needs_a_card_unless_told(tmp_path, monkeypatch, capsys):
    """Without AUDIOWMARK_TORCH_DEVICE the commands run on the card, and
    fail without one; nothing carries on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("there is a card")
    n = str(tmp_path / "n.wav")
    assert _run(t_cli, ["test-gen-noise", n, "1", "44100"], capsys)[0] == 0
    monkeypatch.delenv("AUDIOWMARK_TORCH_DEVICE")
    for argv in (["add", n, str(tmp_path / "o.wav"), MSG], ["get", n],
                 ["test-resample", n, str(tmp_path / "o.wav"), "48000"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            _run(t_cli, argv, capsys)
    assert not os.path.exists(str(tmp_path / "o.wav"))


def test_module_and_launcher_run(tmp_path):
    """`python -m audiowmark_tpu_torch` and ./audiowmark-torch are the
    same command line."""
    env = dict(os.environ, AUDIOWMARK_TORCH_DEVICE="cpu")
    outs = [subprocess.run(cmd + ["test-speed", "--test-key", "4", "42"],
                           capture_output=True, text=True, cwd=REPO, env=env,
                           timeout=120)
            for cmd in ([sys.executable, "-m", "audiowmark_tpu_torch"],
                        [os.path.join(REPO, "audiowmark-torch")])]
    for proc in outs:
        assert proc.returncode == 0, proc.stderr[-2000:]
    assert outs[0].stdout == outs[1].stdout
    assert 0.85 <= float(outs[0].stdout) <= 1.15
    proc = subprocess.run([sys.executable, "-m", "audiowmark_tpu_torch",
                           "get", str(tmp_path / "missing.wav")],
                          capture_output=True, text=True, cwd=REPO, env=env,
                          timeout=120)
    assert proc.returncode == 1 and "Traceback" not in proc.stderr
    assert proc.stderr.startswith("audiowmark: error loading ")


# ---- add, cmp, get and the speed options on a marked file --------------------

def test_add_info_matches_jax(files, tmp_path, capsys):
    """add through both CLIs: the same informational output, the marked
    files within 1 LSB."""
    a, b = str(tmp_path / "j.wav"), str(tmp_path / "t.wav")
    clip = str(tmp_path / "clip.wav")
    w = WavData.load(files["noise"])
    WavData(w.samples[:30 * 44100 * 2], 2, 44100, 16).save(clip)
    j = _run(j_cli, ["add", clip, a, MSG, "--strength", "12"], capsys)
    t = _run(t_cli, ["add", clip, b, MSG, "--strength", "12"], capsys)
    assert j[0] == 0 and "Data Blocks:  1" in j[2]
    assert t[2] == j[2].replace(a, b) and t[:2] == j[:2]
    lsb = np.abs(np.round((WavData.load(a).samples.astype(np.float64)
                           - WavData.load(b).samples) * 32768))
    assert lsb.max() <= 1 and np.count_nonzero(lsb) <= 1e-3 * lsb.size


def test_cmp_and_get_json_match_jax(files, tmp_path, capsys):
    """cmp --expect-matches 5 and 4, and get --json, on the marked file:
    exit codes equal (0, 1, 0), stdout equal with qualities and errors
    within their 3 printed decimals, the JSON documents equal likewise."""
    j, t = _both(["cmp", files["marked"], MSG, "--expect-matches", "5"],
                 capsys)
    assert j[0] == 0 and "match_count 5 " in j[1] \
        and "expect_matches 5" in j[1]
    _assert_same(j, t, 0.002)
    j, t = _both(["cmp", files["marked"], MSG[:-1] + "1"], capsys)
    assert j[0] == 1 and "match_count 0 " in j[1]
    _assert_same(j, t, 0.002)
    a, b = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    j = _run(j_cli, ["get", files["marked"], "--json", a], capsys)
    t = _run(t_cli, ["get", files["marked"], "--json", b], capsys)
    assert j[0] == 0 and "\npattern" in j[1]
    _assert_same(j, t, 0.002)
    ja, jb = json.load(open(a)), json.load(open(b))
    assert ja.keys() == jb.keys() and len(ja["matches"]) == len(jb["matches"])
    for ma, mb in zip(ja["matches"], jb["matches"]):
        assert ma.keys() == mb.keys()
        for k in ma:
            if isinstance(ma[k], float):
                assert abs(ma[k] - mb[k]) <= 0.002, k
            else:
                assert ma[k] == mb[k], k


def test_try_speed_matches_jax(files, capsys):
    """cmp --try-speed 1.01 on the marked file played at 1.01: both print
    `speed 1.010000` and the same -SPEED patterns and match count, and the
    port's speed decode has a trellis launch of its own (two in all)."""
    calls, acs = [], convcode.viterbi_acs

    def recording(bm):
        calls.append(tuple(bm.shape[:2]))
        return acs(bm)

    convcode.viterbi_acs = recording
    try:
        t = _run(t_cli, ["cmp", files["fast"], MSG, "--try-speed", "1.01"],
                 capsys)
    finally:
        convcode.viterbi_acs = acs
    j = _run(j_cli, ["cmp", files["fast"], MSG, "--try-speed", "1.01"],
             capsys)
    assert j[0] == 0 and "speed 1.010000\n" in j[1] and "-SPEED" in j[1]
    _assert_same(j, t, 0.002)
    assert len(calls) == 2 and all(b > 0 for b, _ in calls)
    no_speed = _run(t_cli, ["cmp", files["fast"], MSG], capsys)
    assert no_speed[0] == 1 and "-SPEED" not in no_speed[1]


def test_ber_row_carrier_is_the_ber_tools_carrier(tmp_path):
    """audiowmark_tpu_torch.ber_row runs docs/BER.md's tonal speed-mp3 row
    on the port by default: its carrier is tools/ber_report.py's, byte for
    byte (the other carriers: tests/test_torch_ber_row.py)."""
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import ber_report
    finally:
        sys.path.pop(0)
    from audiowmark_tpu_torch import ber_row
    a, b = str(tmp_path / "tool.wav"), str(tmp_path / "port.wav")
    ber_report.gen_tonal(a, 3)
    ber_row.gen_tonal(b, 3)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    assert ber_row.DEFAULT_ROW == ("music", "speed-mp3:0.9764:128")
