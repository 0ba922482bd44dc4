"""PyTorch/CUDA port of vla_adapter_tpu for NVIDIA Hopper (H100).

Mirrors the JAX package's layout (core/, ops/, models/, infer/, data/,
weights/) and imports nothing from it, nor JAX. Hand-written CUDA kernels
live in csrc/ and are built at first use (ops/cuda_lib.py). Entry points
run on the card unless the caller passes ``device="cpu"``.
"""
