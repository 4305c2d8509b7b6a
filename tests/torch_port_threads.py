"""Torch's CPU threads in the port's test processes.

The suite runs in several processes at once (``pytest -n N``); torch's
default of one thread a core in each of them oversubscribes the cores,
and its OpenMP threads spin while they wait: a ResNet-18 forward on 4
images of 32² took 730 ms with 8 threads a process under the suite's load
against 19 ms with one. Each test process takes its share of the cores."""

import os

import torch

_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
torch.set_num_threads(max(1, (os.cpu_count() or 1) // _workers))
