"""PassiveStatus / Status (reference bvar/passive_status.h:42, status.h:44)."""

from __future__ import annotations

from typing import Callable

from incubator_brpc_tpu_torch.metrics.variable import Variable


class PassiveStatus(Variable):
    """Callback-valued variable: value computed at read time."""

    def __init__(self, getter: Callable[[], object]):
        super().__init__()
        self._getter = getter

    def get_value(self):
        return self._getter()


class Status(Variable):
    """Set-valued variable."""

    def __init__(self, value=None):
        super().__init__()
        self._value = value

    def set_value(self, value):
        self._value = value

    def get_value(self):
        return self._value
