"""Batched scans of detex_torch (namesake of detex_tpu.parallel)."""
