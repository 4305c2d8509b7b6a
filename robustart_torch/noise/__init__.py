"""Corruptions (counterpart of ``robustart_tpu.noise``, the noise family)."""
