"""Command-line interface of the port.

    python -m audiowmark_tpu_torch <command> [ <args>... ]

Port of audiowmark_tpu/cli.py, which mirrors the reference CLI
(src/audiowmark.cc): commands add / get / cmp / gen-key plus the self-hosted
test commands (gentest, cut-start, test-subtract, test-snr, test-clip,
test-speed, test-gen-noise, test-change-speed, test-resample, test-info),
the hand-rolled option parser semantics (`--opt v` and `--opt=v`,
multi-options, positional validation) and exit codes, hls-add and
hls-prepare included (hls/hls.py).

The commands that compute run on the CUDA card and fail without one;
AUDIOWMARK_TORCH_DEVICE=cpu in the environment runs them on the CPU.
AUDIOWMARK_PROFILE=<dir> writes a torch.profiler trace of the whole
command into <dir>.
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional

import numpy as np

from . import __version__
from .crypto.keys import Key
from .crypto.prng import Random, Stream, gen_key as gen_key_hex
from .codec.shortcode import short_code_init
from .device import DeviceLike
from .fixtures import gen_noise
from .io.wavdata import WavData
from .io.streams import StreamError
from .params import Encoding, Format, Params, RawFormat
from .tables import frames_per_block
from .utils.log import Log, error, set_log_level


def _device() -> DeviceLike:
    """The device the commands run on: the CUDA card (None), or what
    AUDIOWMARK_TORCH_DEVICE names."""
    return os.environ.get("AUDIOWMARK_TORCH_DEVICE") or None


def print_usage():
    print("""usage: audiowmark <command> [ <args>... ]

Commands:
  * create a watermarked wav file with a message
    audiowmark add <input_wav> <watermarked_wav> <message_hex>

  * retrieve message
    audiowmark get <watermarked_wav>

  * compare watermark message with expected message
    audiowmark cmp <watermarked_wav> <message_hex>

  * generate 128-bit watermarking key, to be used with --key option
    audiowmark gen-key <key_file> [ --name <key_name> ]

Global options:
  -q, --quiet             disable information messages
  --strict                treat (minor) problems as errors

Options for get / cmp:
  --detect-speed          detect and correct replay speed difference
  --detect-speed-patient  slower, more accurate speed detection
  --json <file>           write JSON results into file

Options for add / get / cmp:
  --key <file>            load watermarking key from file
  --short <bits>          enable short payload mode
  --strength <s>          set watermark strength              [%.6g]

  --input-format raw      use raw stream as input
  --output-format raw     use raw stream as output
  --format raw            use raw stream as input and output

The options to set the raw stream parameters (such as --raw-rate
or --raw-channels) are documented in the README file.

HLS command help can be displayed using --help-hls""" % (Params.water_delta * 1000))


def print_usage_hls():
    print("""usage: audiowmark <command> [ <args>... ]

Commands:
  * prepare HLS segments for streaming:
    audiowmark hls-prepare <input_dir> <output_dir> <playlist_name> <audio_master>

  * watermark one HLS segment:
    audiowmark hls-add <input_ts> <output_ts> <message_hex>

Global options:
  -q, --quiet           disable information messages
  --strict              treat (minor) problems as errors

Watermarking options:
  --strength <s>        set watermark strength              [%.6g]
  --short <bits>        enable short payload mode
  --key <file>          load watermarking key from file
  --bit-rate            set AAC bitrate""" % (Params.water_delta * 1000))


def _die(msg: str):
    error("audiowmark: " + msg + "\n")
    raise SystemExit(1)


def atoi_or_die(s: str) -> int:
    try:
        return int(s, 0)
    except ValueError:
        _die("error during string->int conversion: %s" % s)


def atof_or_die(s: str) -> float:
    try:
        return float(s)
    except ValueError:
        _die("error during string->float conversion: %s" % s)


def _is_option(arg: str) -> bool:
    return len(arg) > 1 and arg[0] == "-"


class ArgParser:
    def __init__(self, argv: List[str]):
        self.args = list(argv)
        self._command = ""

    def parse_cmd(self, cmd: str) -> bool:
        if self.args and self.args[0] == cmd:
            self.args.pop(0)
            self._command = cmd
            return True
        return False

    def parse_multi_opt(self, option: str) -> List[str]:
        values = []
        i = 0
        while i < len(self.args):
            if self.args[i] == option and i + 1 < len(self.args):
                values.append(self.args[i + 1])
                del self.args[i:i + 2]
            elif self.args[i].startswith(option + "="):
                values.append(self.args[i][len(option) + 1:])
                del self.args[i]
            else:
                i += 1
        return values

    def parse_opt_str(self, option: str) -> Optional[str]:
        values = self.parse_multi_opt(option)
        return values[-1] if values else None

    def parse_opt_int(self, option: str) -> Optional[int]:
        s = self.parse_opt_str(option)
        return atoi_or_die(s) if s is not None else None

    def parse_opt_float(self, option: str) -> Optional[float]:
        s = self.parse_opt_str(option)
        return atof_or_die(s) if s is not None else None

    def parse_flag(self, option: str) -> bool:
        if option in self.args:
            self.args.remove(option)
            return True
        return False

    def parse_positional(self, *arg_names: str) -> List[str]:
        if len(self.args) == len(arg_names) \
                and not any(_is_option(a) for a in self.args):
            return list(self.args)
        for arg in self.args:
            if _is_option(arg):
                _die("unsupported option '%s' for command '%s' "
                     "(use audiowmark -h)" % (arg, self._command))
        error("audiowmark: error parsing arguments for command '%s' "
              "(use audiowmark -h)\n\n" % self._command)
        msg = "usage: audiowmark " + self._command + " [options...]"
        for s in arg_names:
            msg += " <" + s + ">"
        error(msg + "\n")
        raise SystemExit(1)

    def command(self) -> str:
        return self._command


def parse_format(s: str) -> Format:
    m = {"raw": Format.RAW, "auto": Format.AUTO, "rf64": Format.RF64,
         "wav-pipe": Format.WAV_PIPE}
    if s not in m:
        _die("unsupported format '%s'" % s)
    return m[s]


def parse_endian(s: str):
    if s == "little":
        return RawFormat.Endian.LITTLE
    if s == "big":
        return RawFormat.Endian.BIG
    _die("unsupported endianness '%s'" % s)


def parse_encoding(s: str, fmt: RawFormat):
    if s == "signed":
        fmt.set_encoding(Encoding.SIGNED)
    elif s == "unsigned":
        fmt.set_encoding(Encoding.UNSIGNED)
    elif s == "float":
        fmt.set_encoding(Encoding.FLOAT)
        fmt.set_bit_depth(32)
    elif s == "double":
        fmt.set_encoding(Encoding.FLOAT)
        fmt.set_bit_depth(64)
    else:
        _die("unsupported encoding '%s'" % s)


def update_raw_bits(fmt: RawFormat, bits: int):
    if fmt.encoding() == Encoding.FLOAT:
        _die("bit depth can not be changed for float / double encoding")
    fmt.set_bit_depth(bits)


def parse_shared_options(ap: ArgParser):
    i = ap.parse_opt_int("--short")
    if i is not None:
        Params.payload_size = i
        if not short_code_init(Params.payload_size):
            _die("unsupported short payload size %d" % Params.payload_size)
        Params.payload_short = True
    i = ap.parse_opt_int("--frames-per-bit")
    if i is not None:
        Params.frames_per_bit = i
    if ap.parse_flag("--linear"):
        Params.mix = False


def parse_key_list(ap: ArgParser) -> List[Key]:
    key_list = []
    for f in ap.parse_multi_opt("--key"):
        key = Key()
        key.load_key(f)
        key_list.append(key)
    for t in ap.parse_multi_opt("--test-key"):
        key = Key()
        key.set_test_key(atoi_or_die(t))
        key_list.append(key)
    if not key_list:
        key_list.append(Key())
    return key_list


def parse_key(ap: ArgParser) -> Key:
    key_list = parse_key_list(ap)
    if len(key_list) > 1:
        _die("watermark key can at most be set once (--key / --test-key option)")
    return key_list[0]


def parse_add_options(ap: ArgParser):
    s = ap.parse_opt_str("--set-input-label")
    if s is not None:
        Params.input_label = s
    s = ap.parse_opt_str("--set-output-label")
    if s is not None:
        Params.output_label = s
    if ap.parse_flag("--snr"):
        Params.snr = True
    s = ap.parse_opt_str("--input-format")
    if s is not None:
        Params.input_format = parse_format(s)
    s = ap.parse_opt_str("--output-format")
    if s is not None:
        Params.output_format = parse_format(s)
    s = ap.parse_opt_str("--format")
    if s is not None:
        Params.input_format = Params.output_format = parse_format(s)
    s = ap.parse_opt_str("--raw-input-endian")
    if s is not None:
        Params.raw_input_format.set_endian(parse_endian(s))
    s = ap.parse_opt_str("--raw-output-endian")
    if s is not None:
        Params.raw_output_format.set_endian(parse_endian(s))
    s = ap.parse_opt_str("--raw-endian")
    if s is not None:
        e = parse_endian(s)
        Params.raw_input_format.set_endian(e)
        Params.raw_output_format.set_endian(e)
    s = ap.parse_opt_str("--raw-input-encoding")
    if s is not None:
        parse_encoding(s, Params.raw_input_format)
    s = ap.parse_opt_str("--raw-output-encoding")
    if s is not None:
        parse_encoding(s, Params.raw_output_format)
    s = ap.parse_opt_str("--raw-encoding")
    if s is not None:
        parse_encoding(s, Params.raw_input_format)
        parse_encoding(s, Params.raw_output_format)
    i = ap.parse_opt_int("--raw-input-bits")
    if i is not None:
        update_raw_bits(Params.raw_input_format, i)
    i = ap.parse_opt_int("--raw-output-bits")
    if i is not None:
        update_raw_bits(Params.raw_output_format, i)
    i = ap.parse_opt_int("--raw-bits")
    if i is not None:
        update_raw_bits(Params.raw_input_format, i)
        update_raw_bits(Params.raw_output_format, i)
    i = ap.parse_opt_int("--raw-channels")
    if i is not None:
        Params.raw_input_format.set_channels(i)
        Params.raw_output_format.set_channels(i)
    i = ap.parse_opt_int("--raw-rate")
    if i is not None:
        Params.raw_input_format.set_sample_rate(i)
        Params.raw_output_format.set_sample_rate(i)
    if ap.parse_flag("--test-no-limiter"):
        Params.test_no_limiter = True
    if Params.input_format == Format.RF64:
        _die("using rf64 as input format has no effect")
    f = ap.parse_opt_float("--strength")
    if f is not None:
        Params.water_delta = f / 1000


def parse_get_options(ap: ArgParser):
    # input-side format options (superset of the reference CLI: its get
    # always sniffs AUTO; we additionally accept explicit raw/wav-pipe input)
    s = ap.parse_opt_str("--input-format")
    if s is not None:
        Params.input_format = parse_format(s)
    s = ap.parse_opt_str("--format")
    if s is not None:
        Params.input_format = parse_format(s)
    s = ap.parse_opt_str("--raw-input-endian")
    if s is not None:
        Params.raw_input_format.set_endian(parse_endian(s))
    s = ap.parse_opt_str("--raw-endian")
    if s is not None:
        Params.raw_input_format.set_endian(parse_endian(s))
    s = ap.parse_opt_str("--raw-input-encoding")
    if s is not None:
        parse_encoding(s, Params.raw_input_format)
    s = ap.parse_opt_str("--raw-encoding")
    if s is not None:
        parse_encoding(s, Params.raw_input_format)
    i = ap.parse_opt_int("--raw-input-bits")
    if i is not None:
        update_raw_bits(Params.raw_input_format, i)
    i = ap.parse_opt_int("--raw-bits")
    if i is not None:
        update_raw_bits(Params.raw_input_format, i)
    i = ap.parse_opt_int("--raw-channels")
    if i is not None:
        Params.raw_input_format.set_channels(i)
    i = ap.parse_opt_int("--raw-rate")
    if i is not None:
        Params.raw_input_format.set_sample_rate(i)

    i = ap.parse_opt_int("--test-cut")
    if i is not None:
        Params.test_cut = i
    i = ap.parse_opt_int("--test-truncate")
    if i is not None:
        Params.test_truncate = i
    if ap.parse_flag("--hard"):
        Params.hard = True
    if ap.parse_flag("--test-no-sync"):
        Params.test_no_sync = True
    speed_options = 0
    if ap.parse_flag("--detect-speed"):
        Params.detect_speed = True
        speed_options += 1
    if ap.parse_flag("--detect-speed-patient"):
        Params.detect_speed_patient = True
        speed_options += 1
    f = ap.parse_opt_float("--try-speed")
    if f is not None:
        speed_options += 1
        Params.try_speed = f
    if speed_options > 1:
        _die("can only use one option: --detect-speed or "
             "--detect-speed-patient or --try-speed")
    f = ap.parse_opt_float("--test-speed")
    if f is not None:
        Params.test_speed = f
    s = ap.parse_opt_str("--json")
    if s is not None:
        Params.json_output = s
    f = ap.parse_opt_float("--chunk-size")
    if f is not None:
        if f < 10:
            _die("--chunk-size needs to be at least 10 minutes")
        Params.get_chunk_size = f
    f = ap.parse_opt_float("--sync-threshold")
    if f is not None:
        Params.sync_threshold2 = f
    i = ap.parse_opt_int("--n-best")
    if i is not None:
        if i < 0:
            _die("--n-best should not be a negative number")
        Params.get_n_best = i


# ---- test commands -----------------------------------------------------------

def gentest(infile: str, outfile: str) -> int:
    print("generating test sample from '%s' to '%s'" % (infile, outfile))
    wav = WavData.load(infile)
    n_samples = 165 * wav.n_channels * wav.sample_rate
    if wav.n_values < n_samples:
        error("audiowmark: input file %s too short\n" % infile)
        return 1
    out = WavData(wav.samples[:n_samples], wav.n_channels, wav.sample_rate,
                  wav.bit_depth)
    out.save(outfile)
    return 0


def cut_start(infile: str, outfile: str, start_str: str) -> int:
    wav = WavData.load(infile)
    start = atoi_or_die(start_str)
    out = WavData(wav.samples[start * wav.n_channels:], wav.n_channels,
                  wav.sample_rate, wav.bit_depth)
    out.save(outfile)
    return 0


def test_subtract(infile1: str, infile2: str, outfile: str) -> int:
    from .utils.log import warning
    in1 = WavData.load(infile1)
    in2 = WavData.load(infile2)
    if in1.n_values != in2.n_values:
        delta = abs(in1.n_values - in2.n_values)
        warning("audiowmark: size mismatch: %d frames\n"
                % (delta // in1.n_channels))
        warning(" - %s frames: %d\n" % (infile1, in1.n_values // in1.n_channels))
        warning(" - %s frames: %d\n" % (infile2, in2.n_values // in2.n_channels))
    n = min(in1.n_values, in2.n_values)
    out = WavData(in1.samples[:n] - in2.samples[:n], in1.n_channels,
                  in1.sample_rate, in1.bit_depth)
    out.save(outfile)
    return 0


def test_snr(orig_file: str, wm_file: str) -> int:
    orig = WavData.load(orig_file)
    wm = WavData.load(wm_file)
    assert orig.n_values == wm.n_values
    o = orig.samples.astype(np.float64)
    delta = o - wm.samples.astype(np.float64)
    print("%f" % (10 * np.log10(np.sum(o * o) / np.sum(delta * delta))))
    return 0


def test_clip(key: Key, in_file: str, out_file: str, seed: int,
              time_seconds: int) -> int:
    in_data = WavData.load(in_file)
    rng = Random(key, seed, Stream.data_up_down)
    while True:
        values_per_block = frames_per_block() * Params.frame_size \
            * in_data.n_channels
        start_point = int(2 * values_per_block * rng.random_double())
        start_point //= in_data.n_channels
        end_point = start_point + time_seconds * in_data.sample_rate
        if end_point < in_data.n_values // in_data.n_channels:
            break
    out = WavData(
        in_data.samples[start_point * in_data.n_channels:
                        end_point * in_data.n_channels],
        in_data.n_channels, in_data.sample_rate, in_data.bit_depth)
    out.save(out_file)
    return 0


def test_speed(key: Key, seed: int) -> int:
    rng = Random(key, seed, Stream.data_up_down)
    low, high = 0.85, 1.15
    print("%.6f" % (low + (rng() / float(2 ** 64 - 1)) * (high - low)))
    return 0


def test_gen_noise(key: Key, out_file: str, seconds: float, rate: int,
                   bits: int) -> int:
    gen_noise(key, out_file, seconds, rate, bits)
    return 0


def test_change_speed(in_file: str, out_file: str, speed: float) -> int:
    from .ops.resample import resample_ratio
    in_data = WavData.load(in_file)
    out = resample_ratio(in_data, 1 / speed, in_data.sample_rate, _device())
    out.save(out_file)
    return 0


def test_resample(in_file: str, out_file: str, new_rate: int) -> int:
    from .ops.resample import resample
    in_data = WavData.load(in_file)
    resample(in_data, new_rate, _device()).save(out_file)
    return 0


def test_info(in_file: str, prop: str) -> int:
    try:
        in_data = WavData.load(in_file)
    except StreamError as e:
        error("audiowmark: error loading %s: %s\n" % (in_file, e))
        return 1
    if prop == "bit_depth":
        print("%d" % in_data.bit_depth)
        return 0
    if prop == "frames":
        print("%d" % in_data.n_frames)
        return 0
    error("audiowmark: unsupported property for test_info: %s\n" % prop)
    return 1


def _escape_key_name(name: str) -> str:
    out = []
    for ch in name:
        if ch in ('"', "\\"):
            out.append("\\" + ch)
        elif ord(ch) >= 32:
            out.append(ch)
        else:
            _die("bad key name: %d is not allowed as character in key names"
                 % ord(ch))
    return "".join(out)


def gen_key_cmd(outfile: str, key_name: str) -> int:
    ename = _escape_key_name(key_name)
    try:
        with open(outfile, "w") as f:
            f.write("# watermarking key for audiowmark\n\nkey %s\n"
                    % gen_key_hex())
            if key_name:
                f.write('name "%s"\n' % ename)
    except OSError as e:
        error("audiowmark: error opening file %s: %s\n" % (outfile, e))
        return 1
    return 0


# ---- main ---------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    # AUDIOWMARK_PROFILE=<dir> records a torch.profiler trace (host and
    # CUDA activities) of the whole command and writes it into the
    # directory as a Chrome trace (chrome://tracing, Perfetto)
    profile_dir = os.environ.get("AUDIOWMARK_PROFILE")
    if not profile_dir:
        return _main(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    try:
        os.makedirs(profile_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        trace = profile(activities=activities)
        trace.__enter__()
    except Exception as e:
        error("audiowmark: cannot start profiler trace in '%s': %s\n"
              % (profile_dir, e))
        return 1
    ret = 1
    try:
        ret = _main(argv)
    finally:
        try:
            trace.__exit__(None, None, None)
            path = os.path.join(profile_dir,
                                "audiowmark-%d.trace.json" % os.getpid())
            trace.export_chrome_trace(path)
            if not os.path.isfile(path):     # the exporter only logs that
                raise OSError("%s was not written" % path)
        except Exception as e:
            error("audiowmark: failed to write profiler trace to "
                  "'%s': %s\n" % (profile_dir, e))
            ret = 1
    return ret


def _main(argv: Optional[List[str]] = None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    ap = ArgParser(argv)

    if ap.parse_flag("--help") or ap.parse_flag("-h"):
        print_usage()
        return 0
    if ap.parse_flag("--help-hls"):
        print_usage_hls()
        return 0
    if ap.parse_flag("--version") or ap.parse_flag("-v"):
        print("audiowmark %s" % __version__)
        return 0
    if ap.parse_flag("--quiet") or ap.parse_flag("-q"):
        set_log_level(Log.WARNING)
    if ap.parse_flag("--strict"):
        Params.strict = True

    if ap.parse_cmd("hls-add"):
        parse_shared_options(ap)
        i = ap.parse_opt_int("--bit-rate")
        if i is not None:
            Params.hls_bit_rate = i
        f = ap.parse_opt_float("--strength")
        if f is not None:
            Params.water_delta = f / 1000
        key = parse_key(ap)
        args = ap.parse_positional("input_ts", "output_ts", "message_hex")
        from .hls.hls import hls_add
        return hls_add(key, args[0], args[1], args[2], _device())
    elif ap.parse_cmd("hls-prepare"):
        i = ap.parse_opt_int("--bit-rate")
        if i is not None:
            Params.hls_bit_rate = i
        args = ap.parse_positional("input_dir", "output_dir",
                                   "playlist_name", "audio_master")
        from .hls.hls import hls_prepare
        return hls_prepare(args[0], args[1], args[2], args[3])
    elif ap.parse_cmd("add"):
        parse_shared_options(ap)
        parse_add_options(ap)
        key = parse_key(ap)
        args = ap.parse_positional("input_wav", "watermarked_wav",
                                   "message_hex")
        from .models.embedder import add_watermark
        return add_watermark(key, args[0], args[1], args[2], _device())
    elif ap.parse_cmd("get"):
        parse_shared_options(ap)
        parse_get_options(ap)
        key_list = parse_key_list(ap)
        args = ap.parse_positional("watermarked_wav")
        from .models.getter import get_watermark
        return get_watermark(key_list, args[0], "", _device())
    elif ap.parse_cmd("cmp"):
        parse_shared_options(ap)
        parse_get_options(ap)
        i = ap.parse_opt_int("--expect-matches")
        if i is not None:
            Params.expect_matches = i
        key_list = parse_key_list(ap)
        args = ap.parse_positional("watermarked_wav", "message_hex")
        from .models.getter import get_watermark
        return get_watermark(key_list, args[0], args[1], _device())
    elif ap.parse_cmd("gen-key"):
        key_name = ap.parse_opt_str("--name") or ""
        args = ap.parse_positional("key_file")
        return gen_key_cmd(args[0], key_name)
    elif ap.parse_cmd("gentest"):
        args = ap.parse_positional("input_wav", "output_wav")
        return gentest(args[0], args[1])
    elif ap.parse_cmd("cut-start"):
        args = ap.parse_positional("input_wav", "output_wav", "cut_samples")
        return cut_start(args[0], args[1], args[2])
    elif ap.parse_cmd("test-subtract"):
        args = ap.parse_positional("input1_wav", "input2_wav", "output_wav")
        return test_subtract(args[0], args[1], args[2])
    elif ap.parse_cmd("test-snr"):
        args = ap.parse_positional("orig_wav", "watermarked_wav")
        return test_snr(args[0], args[1])
    elif ap.parse_cmd("test-clip"):
        parse_shared_options(ap)
        key = parse_key(ap)
        args = ap.parse_positional("input_wav", "output_wav", "seed", "seconds")
        return test_clip(key, args[0], args[1], atoi_or_die(args[2]),
                         atoi_or_die(args[3]))
    elif ap.parse_cmd("test-speed"):
        parse_shared_options(ap)
        key = parse_key(ap)
        args = ap.parse_positional("seed")
        return test_speed(key, atoi_or_die(args[0]))
    elif ap.parse_cmd("test-gen-noise"):
        parse_shared_options(ap)
        bits = ap.parse_opt_int("--bits")
        if bits is None:
            bits = 16
        key = parse_key(ap)
        args = ap.parse_positional("output_wav", "seconds", "sample_rate")
        return test_gen_noise(key, args[0], atof_or_die(args[1]),
                              atoi_or_die(args[2]), bits)
    elif ap.parse_cmd("test-change-speed"):
        parse_shared_options(ap)
        args = ap.parse_positional("input_wav", "output_wav", "speed")
        return test_change_speed(args[0], args[1], atof_or_die(args[2]))
    elif ap.parse_cmd("test-resample"):
        parse_shared_options(ap)
        args = ap.parse_positional("input_wav", "output_wav", "new_rate")
        return test_resample(args[0], args[1], atoi_or_die(args[2]))
    elif ap.parse_cmd("test-info"):
        parse_shared_options(ap)
        args = ap.parse_positional("input_wav", "property")
        return test_info(args[0], args[1])
    elif ap.args:
        s = ap.args[0]
        if _is_option(s):
            error("audiowmark: unsupported global option '%s' "
                  "(use audiowmark -h)\n" % s)
        else:
            error("audiowmark: unsupported command '%s' "
                  "(use audiowmark -h)\n" % s)
        return 1
    error("audiowmark: error parsing commandline args (use audiowmark -h)\n")
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
