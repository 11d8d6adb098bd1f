"""Scalar math helpers (counterpart of ``disco_tpu/core/mathx.py``, the
parts the offline TANGO path uses)."""
from __future__ import annotations

import torch

# float64 machine epsilon — the reference's ``sys.float_info.epsilon``
# (sigproc_utils.py:74, internal_formulas.py:6); shared across the package.
FLOAT64_EPS = 2.220446049250313e-16


def db2lin(x, exp=1):
    """dB -> linear. ``exp=1`` for power, ``exp=2`` for magnitude."""
    return 10.0 ** (torch.as_tensor(x) / (10.0 * exp))
