"""On the card: each cell's control (the reference in float32 with TF32 allowed,
put in the program's place) fails the cell's committed limit, and the
program passes it, at the cells' widths with 2 clips of 2 s a batch.

    python -m pytest benchmark/tests/test_bench_control.py -q

Skips without an NVIDIA card.  The readings at the cells' own sizes, on a
dozen seeds and more, come from ``benchmark/tools/readings.py``.
"""
from __future__ import annotations

import pytest

from benchmark import faults, harness, spec
from benchmark.tests.tiny import ROOT


def _small(name):
    """The cell as committed (its configuration and limit) with a batch of
    2 clips of 2 s."""
    cell = spec.load_cell(ROOT, name)
    cell.mix = dict(cell.mix, batch_clips=2, clip_s=2.0, pool_batches=2, check_batches=1)
    return cell


@pytest.mark.card
@pytest.mark.parametrize("name", ["offline-oracle.north-8x4", "offline-crnn.taslp21-4x4"])
def test_the_control_fails_the_limit_and_the_program_passes(card, name):
    cell = _small(name)
    for seed in (2 ** 31 + 11, 2 ** 31 + 13, 2 ** 31 + 17):
        ok = harness.run_cell(cell, seed, 0.5, False, device=card)
        assert ok["correct"] is True, ok["checks"]
        bad = harness.run_cell(cell, seed, 0.5, False, device=card, variant=faults.control)
        assert bad["correct"] is False, bad["checks"]
