"""PyTorch/CUDA port of client_tpu for an NVIDIA H100."""

__version__ = "0.1.0"
