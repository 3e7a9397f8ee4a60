from .embedder import add_watermark, add_stream_watermark  # noqa: F401
