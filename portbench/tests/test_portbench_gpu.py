"""On the card: each cell's control comes out as not correct and the
program as correct, at a reduced frame size that a test run holds.
Skips without a card; run there with ``pytest portbench/tests -m gpu``.
"""

from __future__ import annotations

import json

import pytest

from conftest import TINY_CELLS

# the tiny cells at a frame size where the card's kernels do real work
SIZES = {"height": 192, "width": 384}


def _needs_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control's readings are the card's")


@pytest.mark.gpu
@pytest.mark.parametrize("variant", [None, "control"])
@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_control_is_not_correct_on_the_card(tiny_root, cell, variant):
    _needs_card()
    from portbench import run
    from portbench.harness import cells

    c = cells.load_cell(tiny_root, cell)
    c.traffic = dict(c.traffic, **SIZES)
    result, _ = run.run_cell(c, 4000000007, 1.0, False, "cuda:0", variant)
    assert result["correct"] is (variant is None), json.dumps(
        result["checks"])
