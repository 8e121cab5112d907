"""Shared helpers of the benchmark's CPU tests: a cell cut to a size the
CPU runs in a second, driven through the harness without the look for a
card (which only ``benchmark/run.py`` makes)."""

from __future__ import annotations

import time

import pytest

from benchmark.harness.cell import find_cell
from benchmark.harness.runner import run_cell

SEED = 2**31 + 977  # larger than 32 signed bits hold, as a run's seed may be
TINY_D = 256
TINY_ROWS = 64
TINY_LAYERS = 2


def tiny_cell(name: str):
    """The cell cut for the CPU: the PS's width and layers, a bulk payload's rows."""
    cell = find_cell(name)
    if "hidden_size" in cell.config:
        cell.config["hidden_size"] = TINY_D
        cell.config["num_attention_heads"] = TINY_D // cell.config["head_dim"]
        cell.config["num_hidden_layers"] = TINY_LAYERS
    payload = cell.traffic.get("payload")
    if payload and payload["shape"][0] > TINY_ROWS:
        payload["shape"] = [TINY_ROWS, 256]
    cell.traffic["warmup_calls"] = min(int(cell.traffic["warmup_calls"]), 32)
    return cell


# a closed loop of 32 calls over 4 channels: the PS batcher coalesces rows
CLOSED_32 = {"generator": "closed_loop", "inflight": 32, "channels": 4}


def run_tiny(name: str, seconds: float = 0.5, trace: bool = False, seed: int = SEED,
             traffic: dict = None, **hooks):
    """``traffic``: parameters laid over the cell's traffic mix; ``hooks``:
    ``before_window`` and ``check`` of ``run_cell``."""
    import torch

    cell = tiny_cell(name)
    cell.traffic.update(traffic or {})
    return run_cell(cell, seed, seconds, trace, torch.device("cpu"), time.perf_counter(), **hooks)


@pytest.fixture
def card():
    """The first card, or a skip where this machine has none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
