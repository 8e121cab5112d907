"""Plain reference of an echo: the reply is the request's bytes, in a
buffer of its own, and the frame checksum is the sum of the payload's
elements.

Plain PyTorch; imports nothing of the program.  Rewritten from the echo
checks of ``chip_smoke.py``'s ``phase_echo`` (bytes equal, a fresh
buffer, the frame checksum), with the checksum recomputed here from the
payload in float64 instead of taken from the program's own kernel: the
number compared is the checksum's gap to the exact sum, over the sum of
magnitudes, so any order of float32 additions passes and a checksum of
other bytes, or one taken in a lower precision, does not.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

BLOCK_BYTES = 256 << 20  # replies compared at once, in bytes of payload
BLOCK_SUMS = 65536


def checksum(pool: torch.Tensor) -> torch.Tensor:
    """Each payload's sum, exact to float64: (n,)"""
    return pool.reshape(pool.shape[0], -1).double().sum(dim=1)


def magnitude(pool: torch.Tensor) -> torch.Tensor:
    """Each payload's sum of magnitudes: the scale a checksum's gap is read against."""
    return pool.reshape(pool.shape[0], -1).double().abs().sum(dim=1)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.uint8).reshape(t.shape[0], -1)


def replies_wrong(kept: List[Tuple[int, torch.Tensor]], pool: torch.Tensor) -> int:
    """How many replies differ from their request in any byte (or shape)."""
    wrong = 0
    block = max(1, BLOCK_BYTES // max(1, pool[0].nbytes))
    for at in range(0, len(kept), block):
        part = kept[at:at + block]
        good = [(i, y) for i, y in part
                if y.shape == pool.shape[1:] and y.dtype == pool.dtype]
        wrong += len(part) - len(good)
        if not good:
            continue
        idx = torch.tensor([i for i, _ in good], device=pool.device)
        got = torch.stack([y.to(pool.device) for _, y in good])
        want = pool.index_select(0, idx)
        wrong += int((_bits(got) != _bits(want)).any(dim=1).sum())
    return wrong


def checksum_gap(sums: List[Tuple[int, torch.Tensor]], ref_sum: torch.Tensor,
                 ref_mag: torch.Tensor) -> float:
    """The widest |checksum - exact sum| / sum of magnitudes over the replies."""
    worst = 0.0
    for at in range(0, len(sums), BLOCK_SUMS):
        part = sums[at:at + BLOCK_SUMS]
        idx = torch.tensor([i for i, _ in part], device=ref_sum.device)
        got = torch.stack([s.reshape(()).to(ref_sum.device) for _, s in part]).double()
        gap = (got - ref_sum[idx]).abs() / ref_mag[idx]
        worst = max(worst, float(gap.max()))
    return worst


def control_reply(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference in the program's place one precision lower
    (bfloat16 for float32): the reply and its checksum taken through
    bfloat16."""
    low = x.to(torch.bfloat16)
    return low.to(x.dtype), low.sum()
