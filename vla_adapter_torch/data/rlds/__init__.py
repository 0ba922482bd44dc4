"""The RLDS data engine of the PyTorch port (mirrors
vla_adapter_tpu/data/rlds), in numpy."""
