"""YAML config system with the reference's config vocabulary.

Counterpart of ``robustart_tpu/core/config.py``: the same recursive
attribute-dict over the reference schema (``model{type,kwargs}``,
``data{...}``, ``saver{pretrain{path,ignore{key,model}}}``, ...). The
loader also expands ``${VAR}`` and ``${VAR:-default}`` in string values, the
form the shipped ``exprs/**/config.yaml`` files use for data roots.
:func:`iter_eval_list` expands a top-level ``eval_list`` (JAX
``core/config.py:127-170``).
"""

from __future__ import annotations

import copy
import io
import os
import re
from typing import Any, Iterator, Mapping

import yaml

_ENV_REF = re.compile(r"\$\{([A-Za-z_][A-Za-z0-9_]*)(?::-([^}]*))?\}")


class Config(dict):
    """Recursive attribute-dict: ``cfg.model.type`` == ``cfg['model']['type']``.

    Missing attribute access raises ``AttributeError`` (not KeyError) so
    ``getattr(cfg, 'ema', None)`` idioms work.
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        super().__init__()
        merged: dict[str, Any] = {}
        if data:
            merged.update(data)
        merged.update(kwargs)
        for key, value in merged.items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, Config):
            return value
        if isinstance(value, Mapping):
            return Config(value)
        if isinstance(value, (list, tuple)):
            return type(value)(Config._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, Config._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def __delattr__(self, key: str) -> None:
        try:
            del self[key]
        except KeyError as exc:
            raise AttributeError(key) from exc

    def merged(self, other: Mapping[str, Any]) -> "Config":
        """Deep-merge ``other`` on top of this config (returns a new Config)."""
        out = copy.deepcopy(self)

        def _merge(dst: Config, src: Mapping[str, Any]) -> None:
            for key, value in src.items():
                if key in dst and isinstance(dst[key], Mapping) and isinstance(value, Mapping):
                    _merge(dst[key], value)
                else:
                    dst[key] = value

        _merge(out, other)
        return out

    def get_path(self, dotted: str, default: Any = None) -> Any:
        """Fetch ``cfg.get_path('data.test.sampler.type')`` with a default."""
        node: Any = self
        for part in dotted.split("."):
            if not isinstance(node, Mapping) or part not in node:
                return default
            node = node[part]
        return node


def expand_env(value: Any) -> Any:
    """Expand ``${VAR}`` / ``${VAR:-default}`` in every string of a tree."""
    if isinstance(value, str):
        return _ENV_REF.sub(
            lambda m: os.environ.get(m.group(1), m.group(2) or ""), value
        )
    if isinstance(value, Mapping):
        return {k: expand_env(v) for k, v in value.items()}
    if isinstance(value, list):
        return [expand_env(v) for v in value]
    return value


def load_config(path_or_stream: str | os.PathLike | io.IOBase) -> Config:
    """Load a YAML config file into a :class:`Config`, expanding ``${VAR}``."""
    if isinstance(path_or_stream, io.IOBase):
        raw = yaml.safe_load(path_or_stream)
    else:
        with open(path_or_stream) as f:
            raw = yaml.safe_load(f)
    if raw is None:
        raw = {}
    if not isinstance(raw, Mapping):
        raise ValueError(f"Config root must be a mapping, got {type(raw)!r}")
    return Config(expand_env(raw))


def iter_eval_list(cfg: Config) -> Iterator[Config]:
    """Expand a top-level ``eval_list`` into per-checkpoint configs: each
    entry (an override dict, or a plain model name, as the reference's batch
    lists give them) deep-merged onto the base, with the model's own input
    size (:func:`_align_input_size`)."""
    entries = cfg.get("eval_list") or [{}]
    for entry in entries:
        if isinstance(entry, str):
            entry = {"model": {"type": entry}}
        sub = cfg.merged(entry if isinstance(entry, Mapping) else {})
        sub.pop("eval_list", None)
        _align_input_size(sub)
        yield sub


def _align_input_size(sub: Config) -> None:
    """Feed a model with a native resolution other than the config's
    (swin_base_384, efficientnet_b3 at 300) its own input size: override
    ``data.input_size`` and scale ``data.test_resize``, keeping the config's
    resize/crop ratio."""
    from robustart_torch.models.registry import model_meta

    try:
        native = int(model_meta(sub.model.type)["input_size"])
    except (KeyError, AttributeError):
        return
    data = sub.get("data")
    if data is None:
        return
    cur = int(data.get("input_size", 224))
    if native == cur:
        return
    resize = int(data.get("test_resize", round(cur * 256 / 224)))
    data.input_size = native
    data.test_resize = max(native, round(resize * native / cur))
