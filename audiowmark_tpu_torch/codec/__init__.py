from .convcode import (  # noqa: F401
    ConvBlockType, conv_code_size, conv_encode, conv_decode_soft,
    conv_decode_hard,
)
from .shortcode import (  # noqa: F401
    short_code_init, short_code_output_size, short_encode, short_decode_soft,
)
from .dispatch import code_encode, code_size, code_decode_soft  # noqa: F401
