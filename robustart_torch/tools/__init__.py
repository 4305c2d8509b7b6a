"""Command-line tools (counterpart of ``robustart_tpu.tools``)."""
