"""The port's marker for subsystems it has not carried over yet.

A branch that would reach one of them raises ``NotImplementedError``
naming its ROADMAP.md item, so nothing on it falls back to the JAX
package or quietly does less.
"""

from __future__ import annotations

from typing import NoReturn


def unported(what: str, item: int) -> NoReturn:
    raise NotImplementedError(
        f"{what} is not ported to incubator_brpc_tpu_torch yet "
        f"(ROADMAP.md queue 1 item {item})"
    )
