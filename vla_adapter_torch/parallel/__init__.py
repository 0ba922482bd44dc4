"""Process groups, device meshes and sharded training (mirrors
vla_adapter_tpu/parallel)."""
