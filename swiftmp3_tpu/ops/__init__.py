"""Device-side numeric core: batched granule DSP as JAX/XLA programs.

`reference.py` holds the numpy golden implementation (the algorithmic spec,
mirroring the reference encoder's op order); the sibling modules implement the
same math as batched fixed-shape jnp programs (plus one Pallas GPU kernel,
pallas_kernels.py), validated against the
golden outputs (integer-exact for quantized values, gains and bit counts).
"""
