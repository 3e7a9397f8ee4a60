from .keys import Key  # noqa: F401
from .prng import Random, Stream, gen_key, seed_from_hash  # noqa: F401
