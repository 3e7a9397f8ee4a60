"""Many streams per call: the device mesh, the sharded batch embed and the
fleet batch API."""

from .mesh import make_mesh, batch_embed_sharded  # noqa: F401
from .batch import watermark_batch, detect_batch  # noqa: F401
