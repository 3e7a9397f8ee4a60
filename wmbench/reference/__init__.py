"""The plain reference of audiowmark in torch and numpy, written from the
upstream semantics.  It imports nothing of audiowmark_tpu_torch, of the
JAX package or of jax, and derives every keyed table from the key."""
