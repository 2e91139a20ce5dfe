"""VTGaussian-SLAM in PyTorch with hand-written CUDA kernels for Hopper.

A port of `vtgaussian_slam_tpu` (JAX/Pallas) that keeps its module layout
and function names. Plain tensor code is PyTorch; the four rasterizer
kernels on the SLAM main path are CUDA C++ for sm_90a
(`csrc/splat.cu`, `csrc/blend.cu`), built with nvcc at first use and bound
with ctypes (`ops/rasterizer/_build.py`).

The CLI (`python -m vtgaussian_slam_tpu_torch <config.py>`) runs online
SLAM over every shipped config family across section boundaries and writes
`params_ls.npy` and `eval/` as the JAX package's does; under torchrun with
`tpu.mesh_devices` it runs tile-sharded over the ranks (`parallel/`).
"""
import torch

# float32 products stay float32: SSIM's depthwise convolution would
# otherwise run through cuDNN in TF32 (about three decimal digits)
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
