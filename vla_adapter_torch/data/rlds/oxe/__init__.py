"""The Open-X Embodiment registry, mixtures and standardization transforms
(mirrors vla_adapter_tpu/data/rlds/oxe)."""
