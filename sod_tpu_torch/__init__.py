"""sod_tpu_torch: the PyTorch/CUDA port of sod_tpu for NVIDIA Hopper (H100).

Plain tensor code is PyTorch; the TPU kernels of ``sod_tpu/ops`` become
CUDA kernels written by hand (``csrc/``), built at first use.  Imports
torch, never jax.
"""
