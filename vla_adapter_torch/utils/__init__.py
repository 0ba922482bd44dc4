"""Utilities of the PyTorch port (mirrors vla_adapter_tpu/utils)."""
