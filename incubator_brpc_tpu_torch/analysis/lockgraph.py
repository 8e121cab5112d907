"""Lock-acquisition graph + the three lock-discipline rules.

Pass 1 walks every function with a lexical "held set": a ``with
<lock>`` body extends the held set; acquisitions, calls, and flagged
operations are recorded against the locks held at that point.

Pass 2 resolves calls (``self.m()``, same-module functions, imported
package modules, known factory idioms like ``get_timer_thread()``) and
computes each function's transitive may-acquire set, producing
inter-module edges: *lock A is held while lock B is acquired*.

Rules emitted (as findings, allowlistable by stable key):

- ``lock-order-cycle``      the edge graph (static ∪ manifest) has a
                            cycle — a real inversion.
- ``lock-order-new-edge``   a static edge absent from the checked-in
                            manifest (``lock_order.json``) — review it,
                            then either fix the code or add the edge
                            with a justification.  Violations are
                            diffs, not noise.
- ``blocking-under-lock``   a blocking operation (sleep, socket send,
                            ``StreamWait``/flow wait, ``condition.wait``
                            on a FOREIGN lock, device dispatch, join)
                            runs while a lock is held.
- ``callback-under-lock``   a user/foreign callback (``done()``, stream
                            handler hooks, hook slots, observers) is
                            invoked while an internal lock is held.

Resolution is deliberately conservative: an attribute acquisition on an
object of unknown type resolves only when the attribute name maps to
exactly one lock in the whole package.  Unresolved acquisitions are
counted (see ``GraphResult.unresolved``) but never guessed.
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from incubator_brpc_tpu_torch.analysis.findings import Finding
from incubator_brpc_tpu_torch.analysis.inventory import (
    Inventory,
    _ctor_kind,
    _threading_aliases,
    iter_py_files,
)

# ---------------------------------------------------------------------------
# rule configuration
# ---------------------------------------------------------------------------

# leaf callable names considered blocking.  `wait`/`wait_for` get the
# own-condition exemption (waiting on a held lock's OWN condition
# releases it — that is what conditions are for).
BLOCKING_LEAFS = {
    "sleep": "time.sleep",
    "sleep_us": "chaos sleep",
    "wait": "wait on a lock/event",
    "wait_for": "condition wait",
    "join": "thread/task join",
    "sendall": "socket send",
    "connect": "socket connect",
    "accept": "socket accept",
    "recv": "socket recv",
    "select": "fd select",
    "run": None,  # only subprocess.run (checked by receiver) blocks
    "write": "socket/stream write",  # transport sends; IOBuf has no write()
    "write_device": "stream device write",
    "block_until_ready": "device sync",
    "device_put": "device transfer",
    "wait_established": "stream establish wait",
}

# receivers whose `.run(` IS blocking
_BLOCKING_RUN_RECEIVERS = {"subprocess"}

# leaf names that are user/foreign callbacks when invoked as a bare
# statement (for effect).  `done()` status *checks* appear in
# conditions, not statements, so they never match.
CALLBACK_LEAFS = {
    "done",
    "on_received_messages",
    "on_closed",
    "on_failed",
    "on_half_close",
    "on_frame",
    "on_finish",
    "emit",
    "_consumer",
    "_batch_fn",
    "_chaos_hook",
    "_dispatcher_hook",
    "_scheduler_hook",
    "_wait_recorder",
    "_task_queue_observer",
    "callback",
    "cb",
}

# factory idiom → (module, class) of the returned object
FACTORIES = {
    "get_timer_thread": ("runtime/timer_thread.py", "TimerThread"),
    "get_task_control": ("runtime/scheduler.py", "TaskControl"),
}

# call depth for blocking propagation: direct + callees that directly
# block.  Deeper chains surface as lock edges instead (a deep block
# almost always involves a condition/lock we can see).
_BLOCK_DEPTH = 1


@dataclass
class Acq:
    lock: str  # canonical base lock name
    line: int


@dataclass
class CallSite:
    callee: Optional[Tuple[str, Optional[str], str]]  # (module, cls, name)
    leaf: str
    receiver: Optional[str]  # textual receiver root, best-effort
    recv_lock: Optional[str]  # receiver resolved to a lock (for .wait)
    line: int
    held: Tuple[str, ...]
    is_stmt: bool  # standalone expression statement


@dataclass
class FuncInfo:
    key: Tuple[str, Optional[str], str]
    direct: List[Acq] = field(default_factory=list)  # acquisitions (any held)
    acq_under: List[Tuple[str, Acq]] = field(default_factory=list)  # (held, acq)
    calls: List[CallSite] = field(default_factory=list)
    blocks_at: List[Tuple[str, int]] = field(default_factory=list)  # (what, line)


@dataclass
class Edge:
    src: str
    dst: str
    module: str
    line: int
    via: str  # "" for a direct nested with, else the call chain


@dataclass
class GraphResult:
    edges: List[Edge]
    findings: List[Finding]
    funcs: Dict[Tuple[str, Optional[str], str], FuncInfo]
    unresolved: List[Tuple[str, int, str]]  # (module, line, expr text)

    def edge_pairs(self) -> Set[Tuple[str, str]]:
        return {(e.src, e.dst) for e in self.edges}


# ---------------------------------------------------------------------------
# per-module function walker
# ---------------------------------------------------------------------------


class _FuncWalker:
    """Walks one function body threading the lexical held set."""

    def __init__(self, scan: "_GraphScan", key, cls: Optional[str]):
        self.scan = scan
        self.inv = scan.inv
        self.module = scan.module
        self.cls = cls
        self.info = FuncInfo(key=key)
        self.local_types: Dict[str, Tuple[str, Optional[str]]] = {}

    # ---- lock reference resolution ----
    def resolve_lock(self, expr: ast.expr) -> Optional[str]:
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
        ):
            root = expr.value.id
            if root == "self" and self.cls:
                site = self.inv.lookup_attr(self.module, self.cls, expr.attr)
                if site is not None:
                    return site.base()
                return None
            # module-alias global: mod._lock
            target = self.scan.imports.get(root)
            if target is not None:
                site = self.inv.lookup_attr(target, None, expr.attr)
                if site is not None:
                    return site.base()
            # typed local: obj._lock where obj's class is tracked
            lt = self.local_types.get(root)
            if lt is not None:
                site = self.inv.lookup_attr(lt[0], lt[1], expr.attr)
                if site is not None:
                    return site.base()
            # unique attribute name anywhere in the package
            site = self.inv.unique_attr(expr.attr)
            if site is not None:
                return site.base()
            return None
        if isinstance(expr, ast.Name):
            site = self.inv.lookup_attr(self.module, None, expr.id)
            if site is not None:
                return site.base()
            site = self.inv.lookup_attr(
                self.module, None if self.cls is None else self.cls, expr.id
            )
            if site is not None:
                return site.base()
            # function-local lock
            fname = self.info.key[2]
            s = self.inv.by_owner.get((self.module, self.cls, expr.id))
            if s is not None:
                return s.base()
            local = f"{self.module}:{fname}.{expr.id}"
            for site2 in self.inv.sites:
                if site2.name == local:
                    return site2.base()
        return None

    # ---- call resolution ----
    def resolve_call(self, call: ast.Call):
        """→ (callee key or None, leaf name, receiver root, recv_lock)."""
        f = call.func
        if isinstance(f, ast.Name):
            leaf = f.id
            key = (self.module, None, leaf)
            if key in self.scan.all_funcs:
                return key, leaf, None, None
            imported = self.scan.from_imports.get(leaf)
            if imported is not None:
                return imported, leaf, None, None
            return None, leaf, None, None
        if isinstance(f, ast.Attribute):
            leaf = f.attr
            recv = f.value
            recv_lock = None
            if isinstance(recv, ast.Name):
                root = recv.id
                if root == "self" and self.cls:
                    key = self._class_method(self.module, self.cls, leaf)
                    if key is not None:
                        return key, leaf, "self", None
                    return None, leaf, "self", None
                target = self.scan.imports.get(root)
                if target is not None:
                    key = (target, None, leaf)
                    if key in self.scan.all_funcs:
                        return key, leaf, root, None
                    return None, leaf, root, None
                lt = self.local_types.get(root)
                if lt is not None:
                    key = self._class_method(lt[0], lt[1], leaf)
                    if key is not None:
                        return key, leaf, root, None
                return None, leaf, root, None
            if isinstance(recv, ast.Attribute):
                # self._cond.wait() — resolve the receiver as a lock
                recv_lock = self.resolve_lock(recv)
                # self.attr.method(): try unique-class resolution off the
                # attr's tracked type? conservative: no
                root = None
                if isinstance(recv.value, ast.Name):
                    root = f"{recv.value.id}.{recv.attr}"
                return None, leaf, root, recv_lock
            if isinstance(recv, ast.Call):
                # factory idiom: get_timer_thread().schedule(...)
                rf = recv.func
                fname = rf.id if isinstance(rf, ast.Name) else (
                    rf.attr if isinstance(rf, ast.Attribute) else None
                )
                if fname in FACTORIES:
                    mod, cls = FACTORIES[fname]
                    key = self._class_method(mod, cls, leaf)
                    if key is not None:
                        return key, leaf, fname + "()", None
                return None, leaf, None, None
            return None, leaf, None, None
        return None, "", None, None

    def _class_method(self, module, cls, name):
        key = (module, cls, name)
        if key in self.scan.all_funcs:
            return key
        for b in self.inv.bases.get((module, cls), []):
            k = self._class_method(module, b, name)
            if k is not None:
                return k
        return None

    # ---- body walk ----
    def walk(self, body: List[ast.stmt], held: Tuple[str, ...]):
        for stmt in body:
            self._stmt(stmt, held)

    def _stmt(self, stmt: ast.stmt, held: Tuple[str, ...]):
        if isinstance(stmt, ast.With):
            new_held = held
            for item in stmt.items:
                self._scan_expr(item.context_expr, new_held, is_stmt=False)
                lk = self.resolve_lock(item.context_expr)
                if lk is None and isinstance(
                    item.context_expr, (ast.Attribute, ast.Name)
                ):
                    txt = ast.unparse(item.context_expr)
                    if "lock" in txt.lower() or "cond" in txt.lower():
                        self.scan.unresolved.append(
                            (self.module, stmt.lineno, txt)
                        )
                if lk is not None:
                    acq = Acq(lk, stmt.lineno)
                    self.info.direct.append(acq)
                    for h in new_held:
                        if h != lk:
                            self.info.acq_under.append((h, acq))
                    if lk not in new_held:
                        new_held = new_held + (lk,)
            self.walk(stmt.body, new_held)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            # nested def: body runs later, not under the current held
            # set — walk it with an empty held set as its own scope
            self.walk(stmt.body, ())
            return
        if isinstance(stmt, ast.ClassDef):
            return
        # track simple local types: x = Factory() / x = pkgClass(...)
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            fn = stmt.value.func
            fname = fn.id if isinstance(fn, ast.Name) else None
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    if fname in FACTORIES:
                        self.local_types[t.id] = FACTORIES[fname]
                    elif fname in self.scan.imported_classes:
                        self.local_types[t.id] = self.scan.imported_classes[
                            fname
                        ]
                    elif fname in self.scan.local_classes:
                        self.local_types[t.id] = (self.module, fname)
        # expression statements: callback detection needs stmt context
        if isinstance(stmt, ast.Expr):
            self._scan_expr(stmt.value, held, is_stmt=True)
        else:
            for fld, value in ast.iter_fields(stmt):
                if fld in ("body", "orelse", "finalbody"):
                    continue
                if isinstance(value, ast.expr):
                    self._scan_expr(value, held, is_stmt=False)
                elif isinstance(value, list):
                    for v in value:
                        if isinstance(v, ast.expr):
                            self._scan_expr(v, held, is_stmt=False)
                        elif isinstance(v, ast.excepthandler):
                            pass
        # recurse into block bodies with the same held set
        for fld in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, fld, None)
            if sub:
                self.walk(sub, held)
        for h in getattr(stmt, "handlers", []) or []:
            self.walk(h.body, held)

    def _scan_expr(self, expr: ast.expr, held: Tuple[str, ...], is_stmt: bool):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            callee, leaf, recv, recv_lock = self.resolve_call(node)
            # lambda bodies execute later — but ast.walk(expr) still
            # reaches them; accept the small over-approximation (a
            # lambda built under a lock usually runs related code)
            self.info.calls.append(
                CallSite(
                    callee=callee,
                    leaf=leaf,
                    receiver=recv,
                    recv_lock=recv_lock,
                    line=node.lineno,
                    held=held,
                    is_stmt=is_stmt and node is expr,
                )
            )


# ---------------------------------------------------------------------------
# module scan: function discovery + imports
# ---------------------------------------------------------------------------


class _GraphScan:
    def __init__(self, inv: Inventory, module: str, tree: ast.Module, pkg: str):
        self.inv = inv
        self.module = module
        self.pkg = pkg  # e.g. "incubator_brpc_tpu_torch"
        self.imports: Dict[str, str] = {}  # alias -> module relpath
        self.from_imports: Dict[str, Tuple[str, Optional[str], str]] = {}
        self.imported_classes: Dict[str, Tuple[str, Optional[str]]] = {}
        self.local_classes: Dict[str, bool] = {}
        self.all_funcs: Set[Tuple[str, Optional[str], str]] = set()
        self.func_nodes: List[Tuple[Tuple[str, Optional[str], str], Optional[str], ast.AST]] = []
        self.unresolved: List[Tuple[str, int, str]] = []
        self.tree = tree
        self.mod_aliases, self.ctor_names = _threading_aliases(tree)
        self._collect(tree)

    def _relmod(self, dotted: str) -> Optional[str]:
        if not dotted.startswith(self.pkg + "."):
            return None
        rel = dotted[len(self.pkg) + 1 :].replace(".", "/") + ".py"
        return rel

    def _collect(self, tree: ast.Module):
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    rel = self._relmod(a.name)
                    if rel is not None:
                        self.imports[(a.asname or a.name.rsplit(".", 1)[-1])] = rel
            elif isinstance(node, ast.ImportFrom):
                if node.module is None:
                    continue
                rel = self._relmod(node.module)
                for a in node.names:
                    alias = a.asname or a.name
                    if rel is not None:
                        # `from pkg.mod import thing`: thing may be a
                        # function (call target) or a class
                        self.from_imports[alias] = (rel, None, a.name)
                        if a.name[:1].isupper():
                            self.imported_classes[alias] = (rel, a.name)
                    else:
                        sub = self._relmod(f"{node.module}.{a.name}")
                        if sub is not None:
                            self.imports[alias] = sub
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                key = (self.module, None, node.name)
                self.all_funcs.add(key)
                self.func_nodes.append((key, None, node))
            elif isinstance(node, ast.ClassDef):
                self.local_classes[node.name] = True
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        key = (self.module, node.name, sub.name)
                        self.all_funcs.add(key)
                        self.func_nodes.append((key, node.name, sub))


# ---------------------------------------------------------------------------
# build + rules
# ---------------------------------------------------------------------------


def build_graph(
    inv: Inventory,
    pkg_name: str = "incubator_brpc_tpu_torch",
    root: Optional[str] = None,
) -> GraphResult:
    root = root or inv.root
    scans: List[_GraphScan] = []
    for path in iter_py_files(root):
        rel = os.path.relpath(path, root)
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        scans.append(_GraphScan(inv, rel, tree, pkg_name))

    all_funcs: Set[Tuple[str, Optional[str], str]] = set()
    for s in scans:
        all_funcs.update(s.all_funcs)
    for s in scans:
        s.all_funcs = all_funcs  # cross-module call resolution

    funcs: Dict[Tuple[str, Optional[str], str], FuncInfo] = {}
    unresolved: List[Tuple[str, int, str]] = []
    for s in scans:
        for key, cls, node in s.func_nodes:
            w = _FuncWalker(s, key, cls)
            w.walk(node.body, ())
            funcs[key] = w.info
        unresolved.extend(s.unresolved)

    # transitive may-acquire (memoized DFS, cycle-safe)
    memo: Dict[Tuple[str, Optional[str], str], Dict[str, str]] = {}

    def may_acquire(key, stack=()):
        if key in memo:
            return memo[key]
        if key in stack:
            return {}
        info = funcs.get(key)
        if info is None:
            return {}
        out: Dict[str, str] = {}
        for acq in info.direct:
            out.setdefault(acq.lock, "")
        for c in info.calls:
            if c.callee is None:
                continue
            sub = may_acquire(c.callee, stack + (key,))
            label = _fmt_key(c.callee)
            for lk, via in sub.items():
                out.setdefault(lk, label + (" -> " + via if via else ""))
        memo[key] = out
        return out

    # direct-block set (for _BLOCK_DEPTH=1 propagation)
    def directly_blocks(info: FuncInfo) -> Optional[str]:
        for c in info.calls:
            what = _blocking_kind(c)
            if what is not None:
                return what
        return None

    blocks: Dict[Tuple[str, Optional[str], str], str] = {}
    for key, info in funcs.items():
        w = directly_blocks(info)
        if w is not None:
            blocks[key] = w

    edges: List[Edge] = []
    findings: List[Finding] = []
    for key, info in funcs.items():
        module = key[0]
        # direct nested-with edges
        for held, acq in info.acq_under:
            edges.append(Edge(held, acq.lock, module, acq.line, ""))
        for c in info.calls:
            # transitive lock edges through resolved calls
            if c.callee is not None and c.held:
                for lk, via in may_acquire(c.callee).items():
                    for h in c.held:
                        if h != lk:
                            chain = _fmt_key(c.callee) + (
                                " -> " + via if via else ""
                            )
                            edges.append(Edge(h, lk, module, c.line, chain))
            # blocking-under-lock
            if c.held:
                what = _blocking_kind(c)
                if what is None and c.callee is not None and _BLOCK_DEPTH:
                    if c.callee in blocks and c.callee != key:
                        what = f"calls {_fmt_key(c.callee)} which {blocks[c.callee]}"
                if what is not None:
                    lockset = ",".join(c.held)
                    findings.append(
                        Finding(
                            rule="blocking-under-lock",
                            key=f"{module}:{key[2]}:{c.leaf}:{lockset}",
                            message=(
                                f"{_fmt_key(key)} holds [{lockset}] while "
                                f"{c.leaf}() may block ({what})"
                            ),
                            file=module,
                            line=c.line,
                        )
                    )
            # callback-under-lock
            if c.held and c.is_stmt and c.leaf in CALLBACK_LEAFS:
                lockset = ",".join(c.held)
                findings.append(
                    Finding(
                        rule="callback-under-lock",
                        key=f"{module}:{key[2]}:{c.leaf}:{lockset}",
                        message=(
                            f"{_fmt_key(key)} invokes callback {c.leaf}() "
                            f"while holding [{lockset}]"
                        ),
                        file=module,
                        line=c.line,
                    )
                )

    # dedupe edges on (src, dst), keeping the first example
    seen: Dict[Tuple[str, str], Edge] = {}
    for e in edges:
        seen.setdefault((e.src, e.dst), e)
    return GraphResult(
        edges=list(seen.values()),
        findings=findings,
        funcs=funcs,
        unresolved=unresolved,
    )


def _fmt_key(key) -> str:
    module, cls, name = key
    return f"{module}:{cls + '.' if cls else ''}{name}"


def _blocking_kind(c: CallSite) -> Optional[str]:
    if c.leaf not in BLOCKING_LEAFS:
        return None
    what = BLOCKING_LEAFS[c.leaf]
    if c.leaf == "run":
        if c.receiver in _BLOCKING_RUN_RECEIVERS:
            return "subprocess.run"
        return None
    if c.leaf in ("wait", "wait_for"):
        # waiting on the OWN condition of the sole held lock releases it
        if c.recv_lock is not None and c.held == (c.recv_lock,):
            return None
        if c.recv_lock is not None and c.recv_lock in c.held and len(c.held) > 1:
            others = [h for h in c.held if h != c.recv_lock]
            return f"cond wait releases only {c.recv_lock}; still holds {others}"
        if c.recv_lock is None and c.receiver in ("self", None):
            # unresolved receiver on self: likely an Event — still a
            # block while holding a lock
            return what
        if c.recv_lock is not None and c.recv_lock not in c.held:
            return f"wait on foreign lock {c.recv_lock}"
        return what
    return what


# ---------------------------------------------------------------------------
# cycle detection over static ∪ manifest edges
# ---------------------------------------------------------------------------


def find_cycles(pairs: Set[Tuple[str, str]]) -> List[List[str]]:
    graph: Dict[str, List[str]] = {}
    for a, b in pairs:
        graph.setdefault(a, []).append(b)
        graph.setdefault(b, [])
    WHITE, GREY, BLACK = 0, 1, 2
    color = {n: WHITE for n in graph}
    cycles: List[List[str]] = []
    path: List[str] = []

    def dfs(n):
        color[n] = GREY
        path.append(n)
        for m in graph[n]:
            if color[m] == GREY:
                i = path.index(m)
                cyc = path[i:] + [m]
                cycles.append(cyc)
            elif color[m] == WHITE:
                dfs(m)
        path.pop()
        color[n] = BLACK

    for n in sorted(graph):
        if color[n] == WHITE:
            dfs(n)
    return cycles
