"""Host ranges the benchmark opens around its calls into each layer.

On in a traced run (``torch.profiler.record_function``), where the
trace names each idle gap of the device by them; a null context
otherwise, so an untraced run pays nothing for them."""

from contextlib import nullcontext


class Ranges:
    def __init__(self, enabled: bool):
        self.enabled = enabled
        if enabled:
            from torch.profiler import record_function

            self._open = record_function
        else:
            self._open = None

    def __call__(self, name: str):
        return self._open(name) if self._open is not None else nullcontext()
