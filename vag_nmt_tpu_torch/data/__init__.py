"""Own copies of the JAX package's host-side data helpers."""
