"""Tensor-level operators of detex_torch (namesake of detex_tpu.ops)."""
