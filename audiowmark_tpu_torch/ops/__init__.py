from .frames import (  # noqa: F401
    analysis_window, synthesis_window, embed_delta_frames, db_spectrogram,
)
from .limiter import limiter_apply, StreamingLimiter  # noqa: F401
