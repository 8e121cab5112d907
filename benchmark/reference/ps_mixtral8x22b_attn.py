"""Plain reference of the PS ``Forward``: y = x @ W in float64.

Plain PyTorch; imports nothing of the program.  Rewritten from the
float64 check of ``chip_smoke.py``'s ``phase_ps``: the number compared
is the widest |y - x @ W| over |x| @ |W| (both in float64) over every
entry of every reply, so an entry's gap is read against the size of the
terms that made it.  W and the rows are the benchmark's own, made from
the seed; the program's stored copy of W is never read.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

BLOCK = 2048  # replies compared at once


def forward(rows: torch.Tensor, W: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(x @ W, |x| @ |W|) of every pool row, in float64."""
    x, w = rows.double(), W.double()
    return x @ w, x.abs() @ w.abs()


def forward_gap(replies: List[Tuple[int, bytes]], rows: torch.Tensor, W: torch.Tensor) -> float:
    """The widest |y - x @ W| / (|x| @ |W|) over every entry of the replies."""
    ref, scale = forward(rows, W)
    worst = 0.0
    for at in range(0, len(replies), BLOCK):
        part = replies[at:at + BLOCK]
        idx = torch.tensor([i for i, _ in part], device=rows.device)
        got = np.frombuffer(b"".join(y for _, y in part), np.float32).reshape(len(part), -1)
        y = torch.from_numpy(got.copy()).to(rows.device).double()
        gap = (y - ref[idx]).abs() / scale[idx]
        worst = max(worst, float(gap.max()))
    return worst


def control_forward(x: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The reference in the program's place one precision lower (TF32
    for float32 with TF32 off): x @ W with both operands rounded to
    TF32's 10-bit mantissa, nearest even, and float32 sums."""
    return round_tf32(x) @ round_tf32(W)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)
