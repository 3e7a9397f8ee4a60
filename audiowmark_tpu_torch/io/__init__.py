from .wavdata import WavData  # noqa: F401
from .streams import (  # noqa: F401
    AudioInputStream, AudioOutputStream, N_FRAMES_UNKNOWN,
    create_input_stream, create_output_stream,
)
