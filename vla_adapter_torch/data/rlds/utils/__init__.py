"""Goal relabeling and task augmentation (mirrors
vla_adapter_tpu/data/rlds/utils), in numpy."""
