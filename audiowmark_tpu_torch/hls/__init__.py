"""HLS segment watermarking: the MPEG-TS piggyback container and the
hls-prepare / hls-add commands."""

from .mpegts import TSReader, TSWriter  # noqa: F401
