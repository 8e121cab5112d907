"""A whole run, with the path under test broken underneath, comes out not
correct: an answer altered where it is produced, half of a batch left
out, a state handed back unchanged, a reply that is the request's own
buffer, a reply from another key's matrix.  The same runs unbroken come out correct."""

from __future__ import annotations

import pytest

from benchmark.harness.cell import cell_names, load_module, load_spec

from .conftest import CLOSED_32, run_tiny


def altered_transmit(monkeypatch):
    """Every transmitted copy has one element changed after its checksum."""
    from incubator_brpc_tpu_torch.ops import transfer

    def wrap(fn):
        def transmit(arr, *args, **kwargs):
            out, csum = fn(arr, *args, **kwargs)
            out.view(-1)[0] += 1.0
            return out, csum
        return transmit

    monkeypatch.setattr(transfer, "transmit_array", wrap(transfer.transmit_array))
    monkeypatch.setattr(transfer, "transmit_array_chunked", wrap(transfer.transmit_array_chunked))


def zero_copy(monkeypatch):
    """The reply moves by reference through the program's own zero-copy
    path: the request's buffer, no checksum."""
    return load_module("deployments", "ici_echo").FAULTS["zero_copy"]


def _forward(monkeypatch, fn):
    from incubator_brpc_tpu_torch.models import parameter_server

    orig = parameter_server._FORWARD_KERNEL
    monkeypatch.setattr(parameter_server, "_FORWARD_KERNEL", lambda w, x: fn(orig, w, x))


def altered_forward(monkeypatch):
    def fn(orig, w, x):
        y = orig(w, x)
        y[0, 0] += 1.0
        return y
    _forward(monkeypatch, fn)


def half_batch(monkeypatch):
    def fn(orig, w, x):
        y = orig(w, x)
        y[x.shape[0] // 2:] = 0
        return y
    _forward(monkeypatch, fn)


def unchanged(monkeypatch):
    _forward(monkeypatch, lambda orig, w, x: x.clone())


def another_key(monkeypatch):
    """The shard answers the served key from another key's matrix."""
    def swap(dep):
        store = dep.service._store
        other = next(k for k in store if k != dep.key)
        store[dep.key], store[other] = store[other], store[dep.key]
    return swap


FAULTS = [
    ("echo.64mb", None, altered_transmit),
    ("echo.4kb", None, altered_transmit),
    ("echo.64mb", None, zero_copy),
    ("echo.4kb", None, zero_copy),
    ("ps.forward.p1", CLOSED_32, altered_forward),
    ("ps.forward.p1", CLOSED_32, half_batch),
    ("ps.forward.p1", CLOSED_32, unchanged),
    ("ps.forward.p1", CLOSED_32, another_key),
    ("ps.forward.p1", None, altered_forward),
    ("ps.forward.p1", None, half_batch),
    ("ps.forward.p1", None, unchanged),
    ("ps.forward.p1", None, another_key),
]


@pytest.mark.parametrize("name,traffic,fault", FAULTS, ids=[
    f"{n}{'-c32' if t else ''}-{f.__name__}" for n, t, f in FAULTS])
def test_a_broken_path_is_not_correct(monkeypatch, name, traffic, fault):
    before = fault(monkeypatch)
    r = run_tiny(name, seconds=0.3, traffic=traffic, before_window=before)
    assert r.attempted > 0
    assert not r.correct
    over = [n for n, c in r.checks.items() if c["value"] > c["limit"]]
    assert over, r.checks


@pytest.mark.parametrize("name", cell_names(load_spec()))
def test_the_unbroken_path_is_correct(name):
    r = run_tiny(name, seconds=0.3)
    assert r.correct, r.checks
    assert r.failed == 0 and r.attempted > 0
