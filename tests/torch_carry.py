"""Carry a JAX-package test file over to the port, unchanged but for the name.

A plain module, not collected itself.  ``carry(globals(), "test_metrics")``
reads ``tests/test_metrics.py``, rewrites every whole-word
``incubator_brpc_tpu`` (imports, function bodies, code strings handed to a
subprocess, paths) to ``incubator_brpc_tpu_torch`` and executes the result in
the calling module's namespace.  The caller then holds the file's ``test_*``
functions, fixtures, marks and parametrisations under their own names, and
pytest collects them as cases of the caller's file:

    from torch_carry import carry

    carry(globals(), "test_metrics")

Nothing else is rewritten.  A file that needs more than the rename to run on
the port is carried by hand.  The line numbers are the JAX file's, so a
traceback points at the carried line; pytest's assertion rewriting is applied
as it would be to the file itself.
"""

import ast
import pathlib
import re

import pytest
import torch
from _pytest.assertion.rewrite import rewrite_asserts

TESTS = pathlib.Path(__file__).resolve().parent
_PACKAGE = re.compile(r"\bincubator_brpc_tpu\b")


def carry(namespace, stem):
    """Execute ``tests/<stem>.py``, with the port's package name, inside
    ``namespace``."""
    path = TESTS / f"{stem}.py"
    source = _PACKAGE.sub("incubator_brpc_tpu_torch", path.read_text())
    tree = ast.parse(source, filename=str(path))
    rewrite_asserts(tree, source.encode(), module_path=str(path))
    exec(compile(tree, str(path), "exec"), namespace)


# ---- for the files carried by hand ----------------------------------------
#
# A case that touches a device value runs twice: on the CPU, where the port's
# wrappers run their plain versions, and on the card (marked ``cuda``; it
# skips without one).  The card's machine has no jax, so a carried file
# imports the JAX package only inside the comparison that needs it.

DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


@pytest.fixture(params=DEVICES)
def torch_device(request):
    """The device a carried case runs on: the CPU, or the card."""
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card: the kernels have no CPU mode")
        return torch.device("cuda", 0)
    return torch.device("cpu")


@pytest.fixture
def card_device():
    """The card, for a carried case whose behaviour exists only there (the
    HBM census reads the CUDA allocator); mark such a case ``cuda``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the census reads the CUDA allocator")
    return torch.device("cuda", 0)
