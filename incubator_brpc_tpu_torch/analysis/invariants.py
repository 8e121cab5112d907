"""Project-invariant lints.

These encode contracts the subsystems rely on but nothing previously
enforced:

- ``chaos-site-doc`` / ``chaos-site-test`` — every site registered in
  ``chaos.injector.SITES`` has a row in docs/chaos.md and at least one
  test referencing it (a site nobody documents or exercises is a fault
  path nobody proved).
- ``metrics-unrenderable`` — every variable registered in the metrics
  registry renders on /metrics: numeric ``get_value()`` or a
  MultiDimension family.  A string-valued PassiveStatus silently
  vanishes from the Prometheus exposition — that must be a deliberate,
  allowlisted choice.
- ``tls-restore`` — a function that stores to a ``_tls`` slot must
  restore it in a ``finally`` of the same function (the nested-inline
  save/restore discipline of nested runs), unless the
  store is a thread-lifetime initialization (allowlisted).
- ``completion-guard`` — configured completion paths (batcher scatter,
  stream close, decode-row finish) carry their exactly-once guard:
  a flag checked-then-set, or a callback swap-to-None.  Controller
  rows must resolve exactly once; fan-out ``done()`` loops must wrap
  each row in try/except so one row's failure cannot strand its
  batch-mates.
- ``except-swallow`` — a broad ``except Exception`` in protocols/ or
  streaming/ whose handler neither re-raises, completes a controller
  (``set_failed``), returns an error sentinel, nor logs, swallows
  ERPC-coded failures into silence.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, Optional, Tuple

from incubator_brpc_tpu_torch.analysis.findings import Finding
from incubator_brpc_tpu_torch.analysis.inventory import iter_py_files

# ---------------------------------------------------------------------------
# chaos sites
# ---------------------------------------------------------------------------


def check_chaos_sites(
    sites: Dict[str, str], docs_text: str, tests_text: str
) -> List[Finding]:
    """`sites` is the injector's SITES dict; `docs_text` the content of
    docs/chaos.md; `tests_text` the concatenated test sources."""
    out: List[Finding] = []
    for site in sorted(sites):
        if f"`{site}`" not in docs_text:
            out.append(
                Finding(
                    rule="chaos-site-doc",
                    key=site,
                    message=f"chaos site {site} has no docs/chaos.md row",
                    file="docs/chaos.md",
                )
            )
        # quoted-token match, not substring: `socket.write` must not
        # earn credit from a test that only mentions `socket.write_io`
        if not re.search(rf"""['"]{re.escape(site)}['"]""", tests_text):
            out.append(
                Finding(
                    rule="chaos-site-test",
                    key=site,
                    message=f"chaos site {site} is referenced by no test",
                    file="tests/",
                )
            )
    return out


def run_chaos_site_lint(repo_root: str) -> List[Finding]:
    from incubator_brpc_tpu_torch.chaos import injector

    docs = _read(os.path.join(repo_root, "docs", "chaos.md"))
    tests = []
    tdir = os.path.join(repo_root, "tests")
    if os.path.isdir(tdir):
        for p in iter_py_files(tdir):
            # a site is tested only by the port's own tests: the JAX
            # package's tests arm the JAX package's injector
            if os.path.basename(p).startswith("test_torch_"):
                tests.append(_read(p))
    return check_chaos_sites(injector.SITES, docs, "\n".join(tests))


def _read(path: str) -> str:
    if not os.path.exists(path):
        return ""
    with open(path, "r", encoding="utf-8") as f:
        return f.read()


# ---------------------------------------------------------------------------
# metrics render on /metrics
# ---------------------------------------------------------------------------

# modules that register variables at import time, jax-free so the lint
# can run anywhere
METRIC_MODULES = (
    "incubator_brpc_tpu_torch.metrics.default_variables",
    "incubator_brpc_tpu_torch.transport.socket",
    "incubator_brpc_tpu_torch.chaos.injector",
    "incubator_brpc_tpu_torch.streaming.observe",
    "incubator_brpc_tpu_torch.server.admission",
    "incubator_brpc_tpu_torch.observability.cluster",
    "incubator_brpc_tpu_torch.cache.store",
    "incubator_brpc_tpu_torch.resharding.migration",
    "incubator_brpc_tpu_torch.replication.metrics",
    "incubator_brpc_tpu_torch.observability.profiling",
    "incubator_brpc_tpu_torch.parallel.ici",
    "incubator_brpc_tpu_torch.metrics.ring_metrics",
    "incubator_brpc_tpu_torch.serving.metrics",
)


def run_metrics_lint() -> List[Finding]:
    import importlib

    for m in METRIC_MODULES:
        importlib.import_module(m)
    from incubator_brpc_tpu_torch.metrics.multi_dimension import MultiDimension
    from incubator_brpc_tpu_torch.metrics.variable import _registry, list_exposed

    out: List[Finding] = []
    for name in list_exposed():
        var = _registry.get(name)
        if var is None:
            continue
        if isinstance(var, MultiDimension):
            continue  # renders one line per labeled sub-variable
        try:
            v = var.get_value()
        except Exception as e:  # noqa: BLE001 — a raising variable IS the bug
            out.append(
                Finding(
                    rule="metrics-unrenderable",
                    key=name,
                    message=f"exposed variable {name}.get_value() raised {e!r}",
                )
            )
            continue
        if isinstance(v, bool) or isinstance(v, (int, float)):
            continue
        out.append(
            Finding(
                rule="metrics-unrenderable",
                key=name,
                message=(
                    f"exposed variable {name} has non-numeric value "
                    f"{type(v).__name__} — it will not render on /metrics"
                ),
            )
        )
    return out


# ---------------------------------------------------------------------------
# _tls save/restore balance
# ---------------------------------------------------------------------------


def _is_tls_store(node: ast.stmt) -> List[str]:
    """Return the _tls attribute names stored by this statement."""
    out = []
    if isinstance(node, ast.Assign):
        targets = node.targets
    elif isinstance(node, ast.AnnAssign) and node.value is not None:
        targets = [node.target]
    else:
        return out
    for t in targets:
        if isinstance(t, ast.Attribute):
            v = t.value
            if isinstance(v, ast.Name) and v.id == "_tls":
                out.append(t.attr)
            elif (
                isinstance(v, ast.Attribute)
                and v.attr == "_tls"
                and isinstance(v.value, ast.Name)
                and v.value.id == "self"
            ):
                out.append(t.attr)
        elif isinstance(t, ast.Tuple):
            for el in t.elts:
                out.extend(_is_tls_store_target(el))
    return out


def _is_tls_store_target(t: ast.expr) -> List[str]:
    if isinstance(t, ast.Attribute):
        v = t.value
        if isinstance(v, ast.Name) and v.id == "_tls":
            return [t.attr]
    return []


def run_tls_lint(pkg_root: str) -> List[Finding]:
    out: List[Finding] = []
    for path in iter_py_files(pkg_root):
        rel = os.path.relpath(path, pkg_root)
        tree = ast.parse(_read(path), filename=path)
        for node in ast.walk(tree):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            plain: Dict[str, int] = {}  # attr -> first store line
            restored: Dict[str, bool] = {}
            for sub in _walk_shallow(node):
                if isinstance(sub, ast.Try):
                    for fin_stmt in sub.finalbody:
                        for st in ast.walk(fin_stmt):
                            if isinstance(st, ast.stmt):
                                for a in _is_tls_store(st):
                                    restored[a] = True
                if isinstance(sub, ast.stmt):
                    for a in _is_tls_store(sub):
                        plain.setdefault(a, sub.lineno)
            for attr, line in plain.items():
                if not restored.get(attr):
                    out.append(
                        Finding(
                            rule="tls-restore",
                            key=f"{rel}:{node.name}:{attr}",
                            message=(
                                f"{rel}:{node.name} stores _tls.{attr} with "
                                f"no restoring store in a finally block"
                            ),
                            file=rel,
                            line=line,
                        )
                    )
    return out


# ---------------------------------------------------------------------------
# completion guards (exactly-once resolution)
# ---------------------------------------------------------------------------

# Each entry names a completion path and how its exactly-once guard
# must look.  types:
#   flag-guard  — method starts by returning early when self.<attr> is
#                 already set, and sets self.<attr> before fan-out
#   none-swap   — the callback attr is swapped to None before invocation
#   fanout-try  — every call to <leaf>() inside a for-loop is wrapped in
#                 try/except so one row cannot strand the rest
COMPLETION_GUARDS = (
    {
        "module": "batching/batcher.py",
        "qualname": "_Scatter.__call__",
        "type": "flag-guard",
        "attr": "called",
    },
    {
        "module": "batching/batcher.py",
        "qualname": "_Scatter.__call__",
        "type": "fanout-try",
        "leaf": "done",
    },
    {
        "module": "batching/batcher.py",
        "qualname": "Batcher._shed",
        "type": "fanout-try",
        "leaf": "done",
    },
    {
        "module": "streaming/stream.py",
        "qualname": "Stream._mark_closed",
        "type": "flag-guard",
        "attr": "_closed",
    },
    {
        "module": "streaming/generate.py",
        "qualname": "DecodeLoop._finish_row",
        "type": "none-swap",
        "attr": "on_finish",
    },
)


def _find_method(tree: ast.Module, qualname: str) -> Optional[ast.AST]:
    parts = qualname.split(".")
    scope: List[ast.stmt] = tree.body
    node: Optional[ast.AST] = None
    for i, part in enumerate(parts):
        node = None
        for n in scope:
            if (
                isinstance(n, (ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef))
                and n.name == part
            ):
                node = n
                break
        if node is None:
            return None
        scope = getattr(node, "body", [])
    return node


def _check_flag_guard(fn: ast.AST, attr: str) -> bool:
    """Early return conditioned on self.<attr> (possibly under a lock),
    and a `self.<attr> = True` store."""
    has_guard = False
    has_set = False
    for node in ast.walk(fn):
        if isinstance(node, ast.If):
            for t in ast.walk(node.test):
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == attr
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    if any(isinstance(s, ast.Return) for s in node.body):
                        has_guard = True
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if (
                    isinstance(t, ast.Attribute)
                    and t.attr == attr
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    has_set = True
    return has_guard and has_set


def _check_none_swap(fn: ast.AST, attr: str) -> bool:
    """A store that Nones <obj>.<attr> (plain or tuple-swap form)."""
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        for t in node.targets:
            elts = t.elts if isinstance(t, ast.Tuple) else [t]
            vals = (
                node.value.elts
                if isinstance(node.value, ast.Tuple)
                else [node.value]
            )
            for el, val in zip(elts, vals):
                if (
                    isinstance(el, ast.Attribute)
                    and el.attr == attr
                    and isinstance(val, ast.Constant)
                    and val.value is None
                ):
                    return True
    return False


def _check_fanout_try(fn: ast.AST, leaf: str) -> bool:
    """Every <row>.<leaf>() call inside a for-loop is under a Try."""
    ok = True
    for node in ast.walk(fn):
        if not isinstance(node, ast.For):
            continue
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Attribute)
                and sub.func.attr == leaf
            ):
                # is this call lexically inside a Try within the loop?
                if not _inside_try(node, sub):
                    ok = False
    return ok


def _inside_try(root: ast.AST, target: ast.AST) -> bool:
    found = [False]

    def walk(n, in_try):
        if n is target:
            found[0] = found[0] or in_try
            return
        for child in ast.iter_child_nodes(n):
            walk(child, in_try or isinstance(n, ast.Try))

    walk(root, False)
    return found[0]


def run_completion_lint(pkg_root: str, guards=COMPLETION_GUARDS) -> List[Finding]:
    out: List[Finding] = []
    trees: Dict[str, ast.Module] = {}
    for g in guards:
        mod = g["module"]
        if mod not in trees:
            path = os.path.join(pkg_root, mod)
            if not os.path.exists(path):
                out.append(
                    Finding(
                        rule="completion-guard",
                        key=f"{mod}:{g['qualname']}",
                        message=f"configured completion path {mod} missing",
                        file=mod,
                    )
                )
                continue
            trees[mod] = ast.parse(_read(path), filename=path)
        fn = _find_method(trees[mod], g["qualname"])
        if fn is None:
            out.append(
                Finding(
                    rule="completion-guard",
                    key=f"{mod}:{g['qualname']}",
                    message=(
                        f"completion path {g['qualname']} not found in {mod} "
                        f"— update analysis config if it moved"
                    ),
                    file=mod,
                )
            )
            continue
        kind = g["type"]
        if kind == "flag-guard":
            ok = _check_flag_guard(fn, g["attr"])
            desc = f"exactly-once flag guard on self.{g['attr']}"
        elif kind == "none-swap":
            ok = _check_none_swap(fn, g["attr"])
            desc = f"swap-to-None of .{g['attr']} before invocation"
        elif kind == "fanout-try":
            ok = _check_fanout_try(fn, g["leaf"])
            desc = (
                f"per-row try/except around .{g['leaf']}() fan-out (one "
                f"row's failure must not strand its batch-mates)"
            )
        else:
            raise ValueError(kind)
        if not ok:
            out.append(
                Finding(
                    rule="completion-guard",
                    key=f"{mod}:{g['qualname']}:{kind}",
                    message=f"{mod}:{g['qualname']} lost its {desc}",
                    file=mod,
                    line=getattr(fn, "lineno", 0),
                )
            )
    return out


# ---------------------------------------------------------------------------
# except-swallow (protocols/ + streaming/)
# ---------------------------------------------------------------------------

EXCEPT_DIRS = ("protocols", "streaming")

# a handler containing any of these is considered to surface the error
_SURFACING_LEAFS = {
    "set_failed",
    "log_error",
    "log_warn",
    "log_info",
    "bad",
    "try_others",
    "not_enough",
    "reset",
    "cancel",
}


def _walk_shallow(fn: ast.AST):
    """ast.walk that does not descend into nested function defs — a
    nested def's handlers belong to the nested def, not its parent."""
    stack = list(ast.iter_child_nodes(fn))
    while stack:
        n = stack.pop()
        yield n
        if not isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            stack.extend(ast.iter_child_nodes(n))


def run_except_lint(pkg_root: str, dirs=EXCEPT_DIRS) -> List[Finding]:
    out: List[Finding] = []
    for d in dirs:
        droot = os.path.join(pkg_root, d)
        if not os.path.isdir(droot):
            continue
        for path in iter_py_files(droot):
            rel = os.path.join(d, os.path.relpath(path, droot))
            tree = ast.parse(_read(path), filename=path)
            # map handlers to their INNERMOST enclosing function
            for node in ast.walk(tree):
                if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                for sub in _walk_shallow(node):
                    if not isinstance(sub, ast.Try):
                        continue
                    for h in sub.handlers:
                        if not _is_broad(h):
                            continue
                        if _handler_surfaces(h):
                            continue
                        out.append(
                            Finding(
                                rule="except-swallow",
                                key=f"{rel}:{node.name}:{h.lineno}",
                                message=(
                                    f"{rel}:{node.name} broad except at line "
                                    f"{h.lineno} swallows the failure "
                                    f"(no re-raise / set_failed / error "
                                    f"sentinel / log)"
                                ),
                                file=rel,
                                line=h.lineno,
                            )
                        )
    return out


def _is_broad(h: ast.excepthandler) -> bool:
    if h.type is None:
        return True
    t = h.type
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in ("Exception", "BaseException") for n in names)


def _handler_surfaces(h: ast.excepthandler) -> bool:
    for node in ast.walk(h):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Return) and node.value is not None:
            # returning a value (error code / sentinel) surfaces it,
            # unless it is literally `return None`
            if not (
                isinstance(node.value, ast.Constant)
                and node.value.value is None
            ):
                return True
        if isinstance(node, ast.Call):
            f = node.func
            leaf = (
                f.attr
                if isinstance(f, ast.Attribute)
                else f.id if isinstance(f, ast.Name) else ""
            )
            if leaf in _SURFACING_LEAFS:
                return True
    return False


# ---------------------------------------------------------------------------
# aggregate
# ---------------------------------------------------------------------------


def run_all(repo_root: str, pkg_root: str) -> List[Finding]:
    out: List[Finding] = []
    out.extend(run_chaos_site_lint(repo_root))
    out.extend(run_metrics_lint())
    out.extend(run_tls_lint(pkg_root))
    out.extend(run_completion_lint(pkg_root))
    out.extend(run_except_lint(pkg_root))
    return out
