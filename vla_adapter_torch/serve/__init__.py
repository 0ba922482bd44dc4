"""The /act server of the PyTorch port (mirrors vla_adapter_tpu/serve)."""
