"""Video helper for the `videowmark-torch` wrapper (a copy of
audiowmark_tpu/video.py on the port's io): probe / extract / remux on
the native libav shim, replacing the ffmpeg CLI steps of the reference's
videowmark script (reference: src/videowmark — audio extraction with
`ffmpeg -f wav`, merge with `-map 0:v -map 1:a -c:v copy -c:a <codec>`).

    python -m audiowmark_tpu_torch.video probe <video>
    python -m audiowmark_tpu_torch.video extract <video> <out.wav>
    python -m audiowmark_tpu_torch.video remux <video> <wm_audio> <out_video>
    python -m audiowmark_tpu_torch.video make-test-video <path> <seconds>

Exit code 0 on success; errors print one `videowmark: error: ...` line.
"""

from __future__ import annotations

import sys

import numpy as np

from .io import ffshim
from .io.streams import StreamError
from .io.wavdata import WavData


def _die(msg: str) -> int:
    sys.stderr.write("videowmark: error: %s\n" % msg)
    return 1


def _check_streams(path: str) -> None:
    n_audio, n_video = ffshim.stream_counts(path)
    if n_audio != 1:
        raise StreamError("input file '%s' should have exactly one audio "
                          "stream (has %d)" % (path, n_audio))
    if n_video < 1:
        raise StreamError("input file '%s' has no video stream" % path)


def extract(video: str, out_wav: str) -> None:
    _check_streams(video)
    stream = ffshim.FFInputStream(video)
    try:
        WavData(ffshim.drain_stream(stream), stream.n_channels(),
                stream.sample_rate(), 16).save(out_wav)
    finally:
        stream.close()


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    try:
        if len(args) == 2 and args[0] == "probe":
            n_audio, n_video = ffshim.stream_counts(args[1])
            print("%s: audio streams: %d, video streams: %d"
                  % (args[1], n_audio, n_video))
            return 0
        if len(args) == 3 and args[0] == "extract":
            extract(args[1], args[2])
            return 0
        if len(args) == 4 and args[0] == "remux":
            _check_streams(args[1])
            ffshim.remux_audio(args[1], args[2], args[3])
            return 0
        if len(args) == 3 and args[0] == "make-test-video":
            ffshim.make_test_video(args[1], float(args[2]))
            return 0
    except StreamError as e:
        return _die(str(e))
    sys.stderr.write(__doc__)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())
