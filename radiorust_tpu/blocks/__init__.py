"""Signal-processing blocks (the DSP operator library).

XLA equivalents of the reference's ``src/blocks/`` modules: each block
is a declarative spec that binds to a (batch, chunk_len, sample_rate)
signature, yielding a pure ``process(state, x, reset)`` function suitable for
``jax.jit`` / ``lax.scan`` composition.
"""
