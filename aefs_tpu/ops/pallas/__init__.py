"""Hand-written kernels and the one place that decides where they run.

Each kernel here is a Pallas kernel through Triton (``backend="triton"``),
compiled for the GPU.  ``gpu_or_plain`` chooses per lowering platform:
the kernel where the op is lowered for CUDA, the plain-XLA form beside
its caller everywhere else — so a program placed on the CPU inside a GPU
process (``jax.default_device``) still runs the plain form.  Tests run
the kernels on the CPU with ``interpret=True``; the program never does.
"""

import jax


def gpu_or_plain(kernel, plain, *args):
    """``kernel(*args)`` when lowered for the GPU, else ``plain(*args)``."""
    return jax.lax.platform_dependent(*args, cuda=kernel, default=plain)
