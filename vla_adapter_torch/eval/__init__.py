"""Closed-loop evaluation and checkpoint tools (mirrors vla_adapter_tpu/eval)."""
