"""robustart_torch — the PyTorch/CUDA port of robustart_tpu for NVIDIA Hopper.

The layout mirrors ``robustart_tpu`` (``core/ data/ metrics/ models/ noise/
ops/ solvers/``) so every module's counterpart is found by its path. The port
imports ``torch`` and never ``jax`` or ``robustart_tpu``; the JAX package is
the reference that ``tests/test_torch_port_*.py`` hold it against.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
hand-written kernels live under ``csrc/`` and are built at first use.
"""
