"""Device-native DSP op library: blocked scans, ring buffers, FFT framing.

These ops replace the reference's seven Numba per-sample kernels
(SURVEY.md "native-code ledger") with XLA-parallel block algorithms.
"""

from aefs_tpu.ops.scan import affine_scan, biquad_block, lag_affine_scan
from aefs_tpu.ops.ringbuf import (
    ring_push,
    delay_read,
    feedback_delay_block,
    allpass_block,
    comb_damped_block,
    fractional_read_cubic,
)
from aefs_tpu.ops.fftops import frame_signal, overlap_add, hann_window

__all__ = [
    "affine_scan",
    "biquad_block",
    "lag_affine_scan",
    "ring_push",
    "delay_read",
    "feedback_delay_block",
    "allpass_block",
    "comb_damped_block",
    "fractional_read_cubic",
    "frame_signal",
    "overlap_add",
    "hann_window",
]
