"""Core runtime: config system and logging."""

from robustart_torch.core.config import Config, load_config
from robustart_torch.core.logging import get_logger

__all__ = ["Config", "load_config", "get_logger"]
