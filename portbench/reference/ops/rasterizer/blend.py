"""Front-to-back compositing constants shared by every render kernel.

Parity: `vtgaussian_slam_tpu/ops/rasterizer/blend.py` (the CUDA
rasterizer's semantics): alpha = min(0.99, opacity * exp(power)); pairs
with alpha < 1/255 are skipped; a Gaussian that would push the pixel's
transmittance below 1e-4 is not blended and ends the pixel.
"""
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_TERMINATE = 1e-4
