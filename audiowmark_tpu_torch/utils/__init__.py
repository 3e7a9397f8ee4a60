from .log import info, warning, error, debug, set_log_level, Log  # noqa: F401
from .hexbits import (  # noqa: F401
    bit_str_to_vec,
    bit_vec_to_str,
    hex_str_to_vec,
    vec_to_hex_str,
)
