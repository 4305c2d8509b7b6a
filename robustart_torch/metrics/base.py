"""Evaluator/Metric base classes (counterpart of
``robustart_tpu/metrics/base.py``).

Evaluators consume per-sample JSON-lines *result files*, not live tensors:
the filesystem is the interface between evaluation and metric computation,
so the port's result files feed either package's evaluators.
"""

from __future__ import annotations

import json
from typing import Any


class Metric:
    """Base metric: a dict of named values plus a comparison key."""

    def __init__(self, metric_dict: dict | None = None):
        self.metric = dict(metric_dict or {})
        self.cmp_key: str | None = None
        self.v: Any = None

    def __str__(self) -> str:
        return f"metric={self.metric} key={self.cmp_key}"

    __repr__ = __str__

    def update(self, up_dict: dict | None = None) -> None:
        self.metric.update(up_dict or {})

    def set_cmp_key(self, key: str) -> None:
        self.cmp_key = key
        self.v = self.metric[key]


class Evaluator:
    """Base class for an evaluator over result files."""

    def eval(self, res_file: str, **kwargs):
        """Return a Metric computed from a JSON-lines result file."""
        raise NotImplementedError


def load_res_columns(res_file: str) -> dict[str, list]:
    """Parse a JSON-lines result file into column lists."""
    res: dict[str, list] = {}
    with open(res_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            info = json.loads(line)
            for key, value in info.items():
                res.setdefault(key, []).append(value)
    return res
