"""PyTorch/CUDA port of nope_tpu for NVIDIA Hopper (sm_90a).

Modules keep the paths and names of their ``nope_tpu`` counterparts.
Public task and serving functions keep the JAX package's NHWC layout
at their boundary; ``nn.Module`` internals are NCHW (channels-last in
memory, so the kernels' NHWC views are free).  Every device is passed
explicitly: nothing here picks a device for the caller.

The three Pallas kernels of ``nope_tpu/ops/experimental`` are
hand-written CUDA kernels here (``csrc/``), built with ``nvcc`` on first
use (:mod:`nope_tpu_torch.ops._build`).  Each op runs its kernel for a
CUDA tensor and its plain PyTorch version for a CPU tensor.
"""
