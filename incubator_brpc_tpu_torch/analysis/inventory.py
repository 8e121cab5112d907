"""AST census of every Lock/RLock/Condition construction in the package.

Each construction site gets a canonical name::

    <relpath>:<Class>.<attr>       instance attr  (self._lock = Lock())
    <relpath>:<module>.<name>      module global  (_lock = Lock())
    <relpath>:<func>.<name>        function local (rare)

``threading.Condition(self._lock)`` is recorded as an ALIAS of the
wrapped lock — acquiring the condition IS acquiring that lock, so the
graph pass folds aliases onto their base lock and never reports a
self-inversion between a lock and its own condition.

The census is also the bridge between the static and runtime views:
witness mode keys runtime acquisitions by creation ``file:line``, which
maps 1:1 onto these sites.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

LOCK_CTORS = ("Lock", "RLock", "Condition")

# directories never scanned (generated code, caches)
SKIP_DIRS = {"__pycache__", "protos"}


@dataclass
class LockSite:
    name: str  # canonical name (see module docstring)
    kind: str  # "lock" | "rlock" | "condition"
    module: str  # path relative to the scan root, e.g. "batching/batcher.py"
    cls: Optional[str]  # enclosing class, or None
    attr: str  # attribute / variable name
    line: int
    alias_of: Optional[str] = None  # canonical name of the wrapped lock

    def base(self) -> str:
        """The lock this site ultimately guards (alias folded)."""
        return self.alias_of or self.name


@dataclass
class Inventory:
    root: str
    sites: List[LockSite] = field(default_factory=list)
    # (module, cls, attr) -> site  — cls None for module globals
    by_owner: Dict[Tuple[str, Optional[str], str], LockSite] = field(
        default_factory=dict
    )
    # creation (module, line) -> site — the witness-mode join key
    by_creation: Dict[Tuple[str, int], LockSite] = field(default_factory=dict)
    # single-module class inheritance: (module, cls) -> [base names]
    bases: Dict[Tuple[str, str], List[str]] = field(default_factory=dict)

    def add(self, site: LockSite) -> None:
        self.sites.append(site)
        self.by_owner[(site.module, site.cls, site.attr)] = site
        self.by_creation[(site.module, site.line)] = site

    def lookup_attr(
        self, module: str, cls: Optional[str], attr: str
    ) -> Optional[LockSite]:
        """Resolve self.<attr> in (module, cls), walking same-module
        base classes (a subclass acquiring an inherited lock)."""
        site = self.by_owner.get((module, cls, attr))
        if site is not None:
            return site
        if cls is not None:
            for b in self.bases.get((module, cls), []):
                site = self.lookup_attr(module, b, attr)
                if site is not None:
                    return site
        return None

    def unique_attr(self, attr: str) -> Optional[LockSite]:
        """Resolve obj.<attr> when the attr names exactly ONE lock in
        the whole package (e.g. `_registry_lock`); ambiguous names like
        `_lock` stay unresolved rather than guessed."""
        found = [s for s in self.sites if s.attr == attr]
        return found[0] if len(found) == 1 else None


def iter_py_files(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


def _threading_aliases(tree: ast.Module) -> Tuple[set, set]:
    """→ (module aliases for `threading`, directly imported ctor names)."""
    mod_aliases, ctor_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "threading":
                    mod_aliases.add(a.asname or "threading")
        elif isinstance(node, ast.ImportFrom) and node.module == "threading":
            for a in node.names:
                if a.name in LOCK_CTORS:
                    ctor_names.add(a.asname or a.name)
    return mod_aliases, ctor_names


def _ctor_kind(call: ast.expr, mod_aliases: set, ctor_names: set) -> Optional[str]:
    if not isinstance(call, ast.Call):
        return None
    f = call.func
    name = None
    if (
        isinstance(f, ast.Attribute)
        and isinstance(f.value, ast.Name)
        and f.value.id in mod_aliases
    ):
        name = f.attr
    elif isinstance(f, ast.Name) and f.id in ctor_names:
        name = f.id
    if name in LOCK_CTORS:
        return name.lower()
    return None


class _ModuleScan(ast.NodeVisitor):
    def __init__(self, inv: Inventory, module: str, tree: ast.Module):
        self.inv = inv
        self.module = module
        self.mod_aliases, self.ctor_names = _threading_aliases(tree)
        self.cls: Optional[str] = None
        self.func: Optional[str] = None
        self._pending_aliases: List[Tuple[LockSite, ast.expr]] = []

    # ---- scope tracking ----
    def visit_ClassDef(self, node: ast.ClassDef):
        prev = self.cls
        self.cls = node.name
        self.inv.bases[(self.module, node.name)] = [
            b.id for b in node.bases if isinstance(b, ast.Name)
        ]
        self.generic_visit(node)
        self.cls = prev

    def _visit_func(self, node):
        prev = self.func
        self.func = node.name
        self.generic_visit(node)
        self.func = prev

    visit_FunctionDef = _visit_func
    visit_AsyncFunctionDef = _visit_func

    # ---- lock constructions ----
    def visit_Assign(self, node: ast.Assign):
        self._check_assign(node.targets, node.value)
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign):
        if node.value is not None:
            self._check_assign([node.target], node.value)
        self.generic_visit(node)

    def _check_assign(self, targets: List[ast.expr], value: ast.expr):
        kind = _ctor_kind(value, self.mod_aliases, self.ctor_names)
        if kind is None:
            return
        for t in targets:
            owner_cls, attr = None, None
            if (
                isinstance(t, ast.Attribute)
                and isinstance(t.value, ast.Name)
                and t.value.id == "self"
                and self.cls
            ):
                owner_cls, attr = self.cls, t.attr
            elif isinstance(t, ast.Name):
                if self.cls and self.func is None:
                    owner_cls, attr = self.cls, t.id  # class-body attr
                elif self.func is None:
                    owner_cls, attr = None, t.id  # module global
                else:
                    # function-local lock: still a site (census + witness
                    # join), scoped by the enclosing function's name
                    site = LockSite(
                        name=f"{self.module}:{self.func}.{t.id}",
                        kind=kind,
                        module=self.module,
                        cls=self.cls,
                        attr=t.id,
                        line=value.lineno,
                    )
                    self.inv.add(site)
                    continue
            else:
                continue
            scope = owner_cls if owner_cls else "<module>"
            site = LockSite(
                name=f"{self.module}:{scope}.{attr}",
                kind=kind,
                module=self.module,
                cls=owner_cls,
                attr=attr,
                line=value.lineno,
            )
            self.inv.add(site)
            if kind == "condition" and isinstance(value, ast.Call) and value.args:
                self._pending_aliases.append((site, value.args[0]))

    def resolve_aliases(self):
        for site, arg in self._pending_aliases:
            base: Optional[LockSite] = None
            if (
                isinstance(arg, ast.Attribute)
                and isinstance(arg.value, ast.Name)
                and arg.value.id == "self"
            ):
                base = self.inv.lookup_attr(self.module, site.cls, arg.attr)
            elif isinstance(arg, ast.Name):
                base = self.inv.lookup_attr(self.module, None, arg.id)
            if base is not None:
                site.alias_of = base.base()


def build_inventory(root: str) -> Inventory:
    """Scan every .py under `root` (a package directory)."""
    inv = Inventory(root=root)
    scans = []
    for path in iter_py_files(root):
        rel = os.path.relpath(path, root)
        with open(path, "r", encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src, filename=path)
        scan = _ModuleScan(inv, rel, tree)
        scan.visit(tree)
        scans.append(scan)
    for scan in scans:
        scan.resolve_aliases()
    return inv
