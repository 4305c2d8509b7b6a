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
    """Base class for an evaluator over result files, with the hooks of the
    offline metric CLI (``python -m robustart_torch.metrics``)."""

    def eval(self, res_file: str, **kwargs):
        """Return a Metric computed from a JSON-lines result file."""
        raise NotImplementedError

    @staticmethod
    def add_subparser(name, subparsers):
        """The CLI subcommand ``name`` with the reference's ``--config`` and
        ``--res_file`` options (``--config`` optional: every evaluator's
        constructor has defaults)."""
        subparser = subparsers.add_parser(
            name, help=f"subcommand for {name} metric"
        )
        subparser.add_argument(
            "--config", dest="config", default=None,
            help="settings of classification in yaml format",
        )
        subparser.add_argument(
            "--res_file", action="append", default=None,
            help="results file of classification",
        )
        return subparser

    @classmethod
    def from_args(cls, args):
        """The evaluator of parsed CLI args: the constructor's keywords from
        ``data.evaluator.kwargs`` or ``data.test.evaluator.kwargs`` of
        ``--config``, keys the constructor does not take dropped."""
        import inspect

        kwargs = {}
        config_path = getattr(args, "config", None)
        if config_path:
            import yaml

            with open(config_path) as f:
                config = yaml.safe_load(f) or {}
            data = config.get("data") or {}
            ev = (
                data.get("evaluator")
                or (data.get("test") or {}).get("evaluator")
                or {}
            )
            kwargs = dict(ev.get("kwargs") or {})
        accepted = inspect.signature(cls.__init__).parameters
        kwargs = {k: v for k, v in kwargs.items() if k in accepted}
        return cls(**kwargs)

    def run_from_args(self, args):
        """The CLI's body: eval each ``--res_file``."""
        out = {}
        for res_file in args.res_file or []:
            metric = self.eval(res_file)
            out[res_file] = (
                dict(metric.metric) if isinstance(metric, Metric) else metric
            )
        return out


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
