from .convcode import ConvBlockType  # noqa: F401
from .dispatch import code_encode, code_size  # noqa: F401
