"""The control comes out not correct: the reference one precision lower in
the program's place (bfloat16 echoes, a TF32 product), while sound runs
of the same cells come out correct.  On the CPU at a tiny size, and on
the card (``cuda``) at the cells' own sizes on three seeds."""

from __future__ import annotations

import time

import pytest

from benchmark.control import control_check
from benchmark.harness.cell import find_cell
from benchmark.harness.runner import run_cell

from .conftest import SEED, run_tiny, tiny_cell


@pytest.mark.parametrize("name", ["echo.64mb", "echo.4kb"])
def test_the_echo_control_fails_on_the_cpu(name):
    check = control_check(tiny_cell(name))
    r = run_tiny(name, seconds=0.3, check=check)
    assert not r.correct
    assert r.checks["reply_bytes_wrong"]["value"] > 0
    assert r.checks["csum_gap"]["value"] > r.checks["csum_gap"]["limit"]


@pytest.mark.parametrize("name", ["ps.forward.p1"])
def test_the_ps_control_fails_on_the_cpu(name):
    check = control_check(tiny_cell(name))
    r = run_tiny(name, seconds=0.3, check=check)
    assert not r.correct
    assert r.checks["y_gap"]["value"] > r.checks["y_gap"]["limit"]


SEEDS = [SEED, SEED + 1, SEED + 2]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["echo.64mb", "echo.4kb", "ps.forward.p1"])
def test_the_control_fails_at_the_cells_size_on_the_card(card, name):
    check = control_check(find_cell(name))
    for seed in SEEDS:
        sound = run_cell(find_cell(name), seed, 1.0, False, card, time.perf_counter())
        assert sound.correct, sound.checks
        ctrl = run_cell(find_cell(name), seed, 1.0, False, card, time.perf_counter(),
                        check=check)
        assert not ctrl.correct, ctrl.checks
