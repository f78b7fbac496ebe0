"""The one matmul precision of every effect path.

Every float32 ``dot``/``einsum``/``@`` that touches audio passes
``precision=DOT_PRECISION``.  The tap and propagator operators are one-hot
or banded selections of samples: at the GPU's default float32 matmul
precision (TF32, 10 mantissa bits) the selected samples themselves are
rounded, an error near -60 dBFS against the -80 dBFS parity bar.
tests/test_precision.py lowers the chains and checks every dot_general.
"""

from jax import lax

DOT_PRECISION = lax.Precision.HIGHEST
