"""AST census of every device-interaction site + the device-plane rules,
in torch spellings.

The lock toolchain (inventory/lockgraph) cannot see the device plane.
A single stray ``.item()``/``.cpu()``/``float(x.sum())`` in the
dispatcher/batcher/stream path silently stalls the serving thread on
the CUDA stream, and a ``torch.compile`` outside the padding-bucket
policy recompiles per shape.  This module is the static half of the
census → justified-manifest → runtime-witness pattern the lock
toolchain uses; ``device_witness`` is the runtime half.  It keeps the
JAX package's rules, ``Finding`` keys and ``HOT_PREFIXES``.

Census kinds (``DeviceSite.kind``):

- ``jit``            ``torch.compile`` / ``torch.jit.script`` /
                     ``torch.jit.trace``, called, as a decorator or
                     through ``functools.partial``
- ``fused-kernel``   ``FusedKernel``/``ShardedFusedKernel`` construction
- ``device-put``     an explicit upload: ``.to(device)`` with a device
                     that is not the CPU, ``.cuda()``,
                     ``torch.tensor``/``torch.as_tensor`` with a
                     ``device=`` that is not the CPU, and ``buf.copy_(x)``
                     into a ``buf`` the same function allocated with
                     such a ``device=``
- ``collective``     the port's lowerings (``psum``, ``psum_in_order``,
                     ``all_gather``, ``all_to_all``, ``ppermute``,
                     ``hedged_first_valid``)
- ``kernel-launch``  a call through the CDLL that ``ops/transfer.py``'s
                     ``_kernels()`` returns — a hand-written CUDA
                     kernel's launch, labelled with the ``pallas_call``
                     of the JAX package it ports (``KERNEL_COUNTERPARTS``)
- ``donation``       a function that launches into a caller's ring slot:
                     it forwards one of its parameters as ``out=``
                     (``device_copy_with_checksum_chunk_into``,
                     ``device_copy_with_checksum_dma_into``)
- ``slot-acquire`` / ``slot-release``
                     StagingRing-shaped pool traffic (receiver name
                     contains ring/staging/freelist)
- ``host-sync``      a construct that forces a device→host sync, each
                     with its own ``sync`` label: ``.item()``,
                     ``.tolist()``, ``.numpy()``, ``.cpu()``,
                     ``.to("cpu")`` / ``.to(torch.device("cpu"))``
                     (``"to_cpu"``), ``np.asarray``/``np.array``/
                     ``np.ascontiguousarray`` (``"asarray"``),
                     ``float()/int()/bool()`` over a reduction like
                     ``x.sum()`` (``"coerce"``), ``torch.cuda.synchronize()``
                     and ``Stream``/``Event.synchronize()``
                     (``"synchronize"``)
- ``allow-scope``    a ``with allowed_transfer("key"):`` justification
                     scope (analysis/device_witness.py)

Rules emitted (all as Findings, allowlistable by stable key):

- ``host-sync-on-hot-path``    a host-sync construct inside a
  dispatcher/batcher/streaming/parallel/server module, outside any
  ``allowed_transfer`` scope.  Fix it (keep the value device-resident)
  or justify it in the transfer manifest and wrap the site.
- ``transfer-manifest``        an ``allowed_transfer`` scope names a key
  absent from the checked-in ``device_transfers.json``.
- ``transfer-manifest-stale``  a manifest entry matched by no scope in
  the tree (entries with ``"external": true`` are exempt).
- ``raw-jit-retrace``          a ``torch.compile``/``torch.jit`` site in
  a request-path module outside the fused-kernel infrastructure:
  nothing bounds its recompiles.  A kernel launch is not one: the CUDA
  library is built once and compiles nothing per shape.
- ``slot-lifecycle``           a staging-slot ``acquire`` whose result
  is never released, handed to a launch into a slot, or returned in the
  same function.
- ``read-after-donate``        a slot read after it went back to its
  ring (``ring.release(slot)``): a torch ``out=`` does not consume its
  buffer as a JAX donation does, so the port's hazard is the next hop's
  launch overwriting a slot the function still reads.
- ``device-dispatch-under-lock`` (``run_dispatch_under_lock``) a fused
  kernel dispatch, a kernel launch or a sync runs while a package lock
  is held.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from incubator_brpc_tpu_torch.analysis.findings import Finding

# directories never scanned (generated code, caches, and this toolchain
# itself — the witness plumbing would self-report)
SKIP_DIRS = {"__pycache__", "protos", "analysis", "_build", "csrc"}

MANIFEST_PATH = os.path.join(os.path.dirname(__file__), "device_transfers.json")

# request-path module prefixes: a host sync here stalls a dispatcher,
# batcher, decode step, transport hop, or recorder
HOT_PREFIXES = (
    "batching/",
    "streaming/",
    "runtime/",
    "server/",
    "transport/",
    "parallel/",
    "observability/",
    "models/",
    "cache/",
)

# fused-kernel infrastructure: a compile here IS the bounded-retrace
# mechanism
JIT_EXEMPT_MODULES = {
    "batching/fused.py",
    "batching/sharded.py",
    "parallel/collectives.py",
}

# the CDLL symbols of ops/csrc/transfer.cu → the pallas_call each ports
# (incubator_brpc_tpu/ops/transfer.py)
KERNEL_COUNTERPARTS = {
    "copy_blocks": "device_copy :59 → pallas_call :68",
    "copy_csum_blocks": (
        "device_copy_with_checksum :91 → :112, "
        "device_copy_with_checksum_chunk :165 → :176, "
        "device_copy_with_checksum_chunk_into :189 → :202"
    ),
    "copy_csum_staged": "_dma_call :373 → pallas_call :388",
}

# the factory whose returned CDLL carries the kernels
_KERNEL_LIB_FACTORY = "_kernels"

# allocators whose ``device=`` places a buffer a later ``.copy_`` fills
_ALLOCATORS = {"empty", "zeros", "ones", "full", "empty_like", "zeros_like"}

# leaf callables that dispatch device work (for the under-lock rule);
# any leaf containing "kernel" (self._kernel(...), kernel(w, X)) counts
DEVICE_DISPATCH_LEAFS = {
    "fused_stack_rows",
    "psum",
    "psum_in_order",
    "all_gather",
    "synchronize",
    "_launch_copy_csum_blocks",
    "_launch_copy_csum_staged",
    "_launch_copy_blocks",
}

_COLLECTIVE_LEAFS = {
    "psum", "psum_in_order", "all_gather", "all_to_all", "ppermute",
    "hedged_first_valid",
}

_REDUCER_ATTRS = {"sum", "mean", "max", "min", "prod", "dot"}

_RING_RECEIVER_HINTS = ("ring", "staging", "freelist")

# tensor methods that pull to the host; each is its own sync label
_PULL_METHODS = {"item", "tolist", "numpy", "cpu"}


@dataclass
class DeviceSite:
    kind: str
    module: str  # path relative to the scan root
    func: str  # "Cls.meth", "name", or "<module>"
    line: int
    detail: str = ""  # callee text / scope key / receiver / counterpart
    sync: str = ""  # host-sync flavor (see module docstring)
    scope_key: str = ""  # enclosing allowed_transfer key, if any
    end_line: int = 0  # last line of the construct (multi-line calls)


@dataclass
class DeviceCensus:
    root: str
    sites: List[DeviceSite] = field(default_factory=list)
    # launch-into-slot callee name -> its slot's positional index
    donating: Dict[str, Tuple[int, ...]] = field(default_factory=dict)

    def by_kind(self, kind: str) -> List[DeviceSite]:
        return [s for s in self.sites if s.kind == kind]


# ---------------------------------------------------------------------------
# transfer manifest (device_transfers.json)
# ---------------------------------------------------------------------------


@dataclass
class DeviceManifest:
    """entries: [{"key", "site", "why"[, "external"]}] — every justified
    device↔host transfer scope, each with a one-line why.  Blank whys
    are refused at load, exactly like the allowlist."""

    entries: List[dict] = field(default_factory=list)
    path: str = MANIFEST_PATH

    def __post_init__(self):
        seen = set()
        for e in self.entries:
            key = e.get("key", "")
            if not key.strip():
                raise ValueError(
                    f"device-transfer manifest entry in {self.path} has an "
                    f"empty key"
                )
            if not e.get("why", "").strip():
                raise ValueError(
                    f"device-transfer manifest entry {key!r} in {self.path} "
                    f"has no justification ('why')"
                )
            if key in seen:
                raise ValueError(
                    f"device-transfer manifest entry {key!r} in {self.path} "
                    f"is duplicated"
                )
            seen.add(key)

    def keys(self) -> Set[str]:
        return {e["key"] for e in self.entries}

    def internal_keys(self) -> Set[str]:
        """Keys whose scope must appear in the package scan (entries
        with "external": true live outside it, e.g. chip_smoke.py)."""
        return {e["key"] for e in self.entries if not e.get("external")}


def load_device_manifest(path: str = MANIFEST_PATH) -> DeviceManifest:
    if not os.path.exists(path):
        return DeviceManifest([], path)
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return DeviceManifest(data.get("transfers", []), path)


# ---------------------------------------------------------------------------
# per-module walker
# ---------------------------------------------------------------------------


def _iter_py_files(root: str) -> List[str]:
    out = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in SKIP_DIRS]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                out.append(os.path.join(dirpath, fn))
    return out


class _ModuleAliases:
    """numpy / torch / functools import aliases in one module."""

    def __init__(self, tree: ast.Module):
        self.np: Set[str] = set()
        self.torch: Set[str] = set()
        self.functools: Set[str] = set()
        # from torch import compile [as c] / from torch.jit import script
        self.jit_names: Set[str] = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    name, asname = a.name, a.asname or a.name.split(".")[0]
                    if name == "numpy":
                        self.np.add(asname)
                    elif name == "torch" or name.startswith("torch."):
                        self.torch.add(asname if a.asname is None else a.asname)
                    elif name == "functools":
                        self.functools.add(asname)
            elif isinstance(node, ast.ImportFrom):
                if node.module == "torch":
                    for a in node.names:
                        if a.name == "compile":
                            self.jit_names.add(a.asname or a.name)
                elif node.module == "torch.jit":
                    for a in node.names:
                        if a.name in ("script", "trace"):
                            self.jit_names.add(a.asname or a.name)


def _attr_chain(node: ast.expr) -> List[str]:
    """a.b.c -> ["a", "b", "c"]; returns [] for non-name chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        parts.reverse()
        return parts
    return []


class _DeviceWalker:
    def __init__(self, census: DeviceCensus, module: str, tree: ast.Module):
        self.census = census
        self.module = module
        self.aliases = _ModuleAliases(tree)
        self.tree = tree
        # function ast nodes for the second-pass rules
        self.func_nodes: List[Tuple[str, ast.AST]] = []
        # names bound to the kernels' CDLL, and to buffers allocated on a
        # device, in the function being walked
        self._libs: Set[str] = set()
        self._dev_bufs: Set[str] = set()

    # ---- classification helpers ----
    def _is_jit_ref(self, expr: ast.expr) -> bool:
        chain = _attr_chain(expr)
        if len(chain) == 2 and chain[0] in self.aliases.torch:
            return chain[1] == "compile"
        if len(chain) == 3 and chain[0] in self.aliases.torch:
            return chain[1] == "jit" and chain[2] in ("script", "trace")
        return len(chain) == 1 and chain[0] in self.aliases.jit_names

    def _is_jit_call(self, call: ast.Call) -> bool:
        if self._is_jit_ref(call.func):
            return True
        # functools.partial(torch.compile, ...)
        chain = _attr_chain(call.func)
        return bool(
            chain
            and chain[-1] == "partial"
            and (len(chain) == 1 or chain[0] in self.aliases.functools)
            and call.args
            and self._is_jit_ref(call.args[0])
        )

    def _is_cpu_device(self, expr: ast.expr) -> bool:
        """"cpu" / torch.device("cpu") / torch.device(type="cpu")."""
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value.split(":")[0] == "cpu"
        if isinstance(expr, ast.Call):
            chain = _attr_chain(expr.func)
            if (
                len(chain) == 2
                and chain[0] in self.aliases.torch
                and chain[1] == "device"
            ):
                args = list(expr.args) + [k.value for k in expr.keywords]
                return bool(args) and self._is_cpu_device(args[0])
        return False

    def _is_dtype(self, expr: ast.expr) -> bool:
        """torch.float32 / x.dtype / a name spelled like a dtype."""
        chain = _attr_chain(expr)
        if len(chain) == 2 and chain[0] in self.aliases.torch:
            return chain[1] != "device"
        return bool(chain) and "dtype" in chain[-1].lower()

    def _to_target(self, call: ast.Call) -> Optional[ast.expr]:
        """The device operand of ``x.to(...)``, or None when the call
        converts only the dtype (or moves to another tensor's place)."""
        for kw in call.keywords:
            if kw.arg == "device":
                return kw.value
        if not call.args or self._is_dtype(call.args[0]):
            return None
        return call.args[0]

    def _scope_key_of(self, item: ast.withitem) -> Optional[str]:
        """`with allowed_transfer("key")` / `with dw.allowed_transfer("key")`."""
        ctx = item.context_expr
        if not isinstance(ctx, ast.Call):
            return None
        chain = _attr_chain(ctx.func)
        if not chain or chain[-1] != "allowed_transfer":
            return None
        if ctx.args and isinstance(ctx.args[0], ast.Constant) and isinstance(
            ctx.args[0].value, str
        ):
            return ctx.args[0].value
        return ""  # non-literal key: recorded, flagged by the manifest rule

    # ---- walk ----
    def walk_module(self):
        self._walk_body(self.tree.body, func="<module>", cls=None, scope="")

    def _walk_body(self, body, func: str, cls: Optional[str], scope: str):
        for stmt in body:
            self._stmt(stmt, func, cls, scope)

    def _stmt(self, stmt: ast.stmt, func: str, cls: Optional[str], scope: str):
        if isinstance(stmt, ast.ClassDef):
            for sub in stmt.body:
                self._stmt(sub, func="<class>", cls=stmt.name, scope=scope)
            return
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            qual = f"{cls}.{stmt.name}" if cls else stmt.name
            self.func_nodes.append((qual, stmt))
            for dec in stmt.decorator_list:
                self._decorator(dec, qual, scope)
            self._donation(stmt, qual, scope)
            saved = self._libs, self._dev_bufs
            self._libs, self._dev_bufs = set(), set()
            self._walk_body(stmt.body, func=qual, cls=cls, scope=scope)
            self._libs, self._dev_bufs = saved
            return
        if isinstance(stmt, ast.With):
            new_scope = scope
            for item in stmt.items:
                key = self._scope_key_of(item)
                if key is not None:
                    self._add("allow-scope", func, stmt.lineno, detail=key,
                              scope=scope)
                    new_scope = key
                else:
                    self._expr(item.context_expr, func, scope)
            self._walk_body(stmt.body, func, cls, new_scope)
            return
        # lib = _kernels(): later calls on `lib` launch kernels
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            chain = _attr_chain(stmt.value.func)
            names = [t.id for t in stmt.targets if isinstance(t, ast.Name)]
            if chain and chain[-1] == _KERNEL_LIB_FACTORY:
                self._libs.update(names)
            elif (
                len(chain) == 2
                and chain[0] in self.aliases.torch
                and chain[1] in _ALLOCATORS
                and any(kw.arg == "device" and not self._is_cpu_device(kw.value)
                        for kw in stmt.value.keywords)
            ):
                self._dev_bufs.update(names)
        for fld, value in ast.iter_fields(stmt):
            if fld in ("body", "orelse", "finalbody", "handlers"):
                continue
            if isinstance(value, ast.expr):
                self._expr(value, func, scope)
            elif isinstance(value, list):
                for v in value:
                    if isinstance(v, ast.expr):
                        self._expr(v, func, scope)
        for fld in ("body", "orelse", "finalbody"):
            sub = getattr(stmt, fld, None)
            if sub:
                self._walk_body(sub, func, cls, scope)
        for h in getattr(stmt, "handlers", []) or []:
            self._walk_body(h.body, func, cls, scope)

    def _decorator(self, dec: ast.expr, qual: str, scope: str):
        # @torch.compile / @torch.jit.script / @torch.compile(...) /
        # @functools.partial(torch.compile, ...)
        if self._is_jit_ref(dec) or (
            isinstance(dec, ast.Call) and self._is_jit_call(dec)
        ):
            self._add("jit", qual, dec.lineno, detail="@jit", scope=scope)

    def _donation(self, fn: ast.AST, qual: str, scope: str):
        """A def that forwards a parameter as ``out=`` launches into its
        caller's buffer (the slot a JAX kernel would take donated)."""
        params = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            for kw in node.keywords:
                if (
                    kw.arg == "out"
                    and isinstance(kw.value, ast.Name)
                    and kw.value.id in params
                ):
                    idx = params.index(kw.value.id)
                    self._add("donation", qual, fn.lineno,
                              detail=f"out={kw.value.id} (arg {idx})",
                              scope=scope)
                    self.census.donating[qual.rsplit(".", 1)[-1]] = (idx,)
                    return

    def _expr(self, expr: ast.expr, func: str, scope: str):
        for node in ast.walk(expr):
            if not isinstance(node, ast.Call):
                continue
            self._call(node, func, scope)

    def _call(self, call: ast.Call, func: str, scope: str):
        def add(kind, detail, sync=""):
            self._add(kind, func, call, detail=detail, sync=sync, scope=scope)

        chain = _attr_chain(call.func)
        leaf = chain[-1] if chain else (
            call.func.attr if isinstance(call.func, ast.Attribute) else ""
        )
        # torch.compile / torch.jit (incl. partial(torch.compile, ...))
        if self._is_jit_call(call):
            add("jit", detail=".".join(chain))
            return
        # a hand-written kernel's launch through the CDLL
        if isinstance(call.func, ast.Attribute):
            recv = call.func.value
            via_lib = isinstance(recv, ast.Name) and recv.id in self._libs
            via_factory = isinstance(recv, ast.Call) and (
                _attr_chain(recv.func)[-1:] == [_KERNEL_LIB_FACTORY]
            )
            if via_lib or via_factory:
                label = KERNEL_COUNTERPARTS.get(call.func.attr)
                if label is not None:
                    add("kernel-launch", detail=f"{call.func.attr} ← {label}")
                return
        # fused-kernel construction
        if leaf in ("FusedKernel", "ShardedFusedKernel"):
            add("fused-kernel", detail=leaf)
            return
        # explicit uploads
        if isinstance(call.func, ast.Attribute) and call.func.attr == "cuda":
            add("device-put", detail=".cuda()")
            return
        if (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "copy_"
            and isinstance(call.func.value, ast.Name)
            and call.func.value.id in self._dev_bufs
        ):
            add("device-put", detail=".copy_()")
            return
        if len(chain) == 2 and chain[0] in self.aliases.torch and leaf in (
            "tensor", "as_tensor"
        ):
            for kw in call.keywords:
                if kw.arg == "device" and not self._is_cpu_device(kw.value):
                    add("device-put", detail=leaf)
                    return
            return
        if isinstance(call.func, ast.Attribute) and call.func.attr == "to":
            target = self._to_target(call)
            if target is None:
                return
            if self._is_cpu_device(target):
                add("host-sync", detail='.to("cpu")', sync="to_cpu")
            else:
                add("device-put", detail=".to(device)")
            return
        # collectives
        if leaf in _COLLECTIVE_LEAFS:
            add("collective", detail=leaf)
            return
        # staging-slot traffic
        if leaf in ("acquire", "release") and len(chain) >= 2:
            recv = ".".join(chain[:-1]).lower()
            if any(h in recv for h in _RING_RECEIVER_HINTS):
                add(f"slot-{leaf}", detail=".".join(chain[:-1]))
                return
        # host syncs
        if leaf in ("asarray", "array", "ascontiguousarray") and (
            len(chain) == 2 and chain[0] in self.aliases.np
        ):
            add("host-sync", detail=leaf, sync="asarray")
            return
        # method syncs match on the attribute itself, not the chain —
        # `fn(x).item()` has no resolvable name chain but still syncs
        if isinstance(call.func, ast.Attribute):
            attr = call.func.attr
            if attr in _PULL_METHODS and not call.args:
                add("host-sync", detail=f".{attr}()", sync=attr)
                return
            if attr == "synchronize":
                add("host-sync", detail=".".join(chain) or ".synchronize()",
                    sync="synchronize")
                return
        if (
            isinstance(call.func, ast.Name)
            and call.func.id in ("float", "int", "bool")
            and call.args
            and self._contains_reduction(call.args[0])
        ):
            reducer = self._reduction_attr(call.args[0])
            add("host-sync", detail=f"{call.func.id}(…{reducer}())",
                sync="coerce")
            return

    @staticmethod
    def _contains_reduction(expr: ast.expr) -> bool:
        for node in ast.walk(expr):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _REDUCER_ATTRS
            ):
                return True
        return False

    @staticmethod
    def _reduction_attr(expr: ast.expr) -> str:
        for node in ast.walk(expr):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _REDUCER_ATTRS
            ):
                return node.func.attr
        return ""

    def _add(self, kind, func, where, detail="", sync="", scope=""):
        """``where`` is a line, or the ast node of the construct (its
        line range is kept for the runtime witness's join)."""
        if isinstance(where, ast.AST):
            line = where.lineno
            end = getattr(where, "end_lineno", line) or line
        else:
            line = end = where
        self.census.sites.append(
            DeviceSite(
                kind=kind,
                module=self.module,
                func=func,
                line=line,
                detail=detail,
                sync=sync,
                scope_key=scope,
                end_line=end,
            )
        )


def build_device_census(root: str) -> DeviceCensus:
    """Scan every .py under `root` (the package directory)."""
    census = DeviceCensus(root=root)
    walkers: List[_DeviceWalker] = []
    for path in _iter_py_files(root):
        rel = os.path.relpath(path, root)
        with open(path, "r", encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        w = _DeviceWalker(census, rel, tree)
        w.walk_module()
        walkers.append(w)
    census._walkers = walkers  # kept for the second-pass rules
    return census


# ---------------------------------------------------------------------------
# rules
# ---------------------------------------------------------------------------


def _is_hot(module: str, hot_prefixes) -> bool:
    return any(module.startswith(p) for p in hot_prefixes)


def run_device_rules(
    census: DeviceCensus,
    manifest: Optional[DeviceManifest] = None,
    hot_prefixes=HOT_PREFIXES,
    jit_exempt=JIT_EXEMPT_MODULES,
) -> List[Finding]:
    if manifest is None:
        manifest = load_device_manifest()
    findings: List[Finding] = []

    # host-sync-on-hot-path: occurrence-indexed keys so two same-kind
    # syncs in one function stay separately allowlistable
    occ: Dict[Tuple[str, str, str], int] = {}
    for s in census.sites:
        if s.kind != "host-sync":
            continue
        if not _is_hot(s.module, hot_prefixes):
            continue
        if s.scope_key:
            continue  # justified via the manifest (checked below)
        k = (s.module, s.func, s.sync)
        n = occ.get(k, 0)
        occ[k] = n + 1
        findings.append(
            Finding(
                rule="host-sync-on-hot-path",
                key=f"{s.module}:{s.func}:{s.sync}:{n}",
                message=(
                    f"{s.module}:{s.func} forces a device→host sync "
                    f"({s.detail}) on a request path — keep the value "
                    f"device-resident or wrap the site in "
                    f"allowed_transfer(<key>) with a manifest entry"
                ),
                file=s.module,
                line=s.line,
            )
        )

    # transfer-manifest: scope keys ↔ manifest entries, both directions
    used_keys: Set[str] = set()
    for s in census.by_kind("allow-scope"):
        key = s.detail
        if not key:
            findings.append(
                Finding(
                    rule="transfer-manifest",
                    key=f"{s.module}:{s.func}:<non-literal>",
                    message=(
                        f"{s.module}:{s.func} enters allowed_transfer with a "
                        f"non-literal key — the manifest can only justify "
                        f"string-literal keys"
                    ),
                    file=s.module,
                    line=s.line,
                )
            )
            continue
        used_keys.add(key)
        if key not in manifest.keys():
            findings.append(
                Finding(
                    rule="transfer-manifest",
                    key=f"{s.module}:{s.func}:{key}",
                    message=(
                        f"{s.module}:{s.func} justifies a transfer under key "
                        f"{key!r} but {os.path.basename(manifest.path)} has "
                        f"no such entry — add it with a 'why'"
                    ),
                    file=s.module,
                    line=s.line,
                )
            )
    for key in sorted(manifest.internal_keys() - used_keys):
        findings.append(
            Finding(
                rule="transfer-manifest-stale",
                key=key,
                message=(
                    f"device-transfer manifest entry {key!r} matches no "
                    f"allowed_transfer scope in the tree — remove it (the "
                    f"justified transfer is gone)"
                ),
            )
        )

    # raw-jit-retrace
    for s in census.by_kind("jit"):
        if not _is_hot(s.module, hot_prefixes) or s.module in jit_exempt:
            continue
        findings.append(
            Finding(
                rule="raw-jit-retrace",
                key=f"{s.module}:{s.func}:jit",
                message=(
                    f"{s.module}:{s.func} compiles ({s.detail}) on a request "
                    f"path — nothing bounds its recompiles; route it through "
                    f"FusedKernel/padding buckets or allowlist with a why"
                ),
                file=s.module,
                line=s.line,
            )
        )

    # slot-lifecycle + read-after-donate need function-local dataflow
    for w in getattr(census, "_walkers", []):
        for qual, node in w.func_nodes:
            findings.extend(
                _slot_and_donate_rules(census, w.module, qual, node)
            )

    return findings


def _ring_call(call: ast.Call, leaf: str) -> bool:
    chain = _attr_chain(call.func)
    return (
        len(chain) >= 2
        and chain[-1] == leaf
        and any(h in ".".join(chain[:-1]).lower() for h in _RING_RECEIVER_HINTS)
    )


def _slot_and_donate_rules(
    census: DeviceCensus, module: str, qual: str, node: ast.AST
) -> List[Finding]:
    findings: List[Finding] = []
    acquired: Dict[str, int] = {}  # name -> line
    released: Dict[str, int] = {}  # name -> end line of its release call
    release_receivers = False
    donated_names: Set[str] = set()
    returned: Set[str] = set()

    for sub in ast.walk(node):
        if isinstance(sub, ast.Assign) and isinstance(sub.value, ast.Call):
            if _ring_call(sub.value, "acquire"):
                for t in sub.targets:
                    if isinstance(t, ast.Name):
                        acquired[t.id] = sub.lineno
        if isinstance(sub, ast.Call):
            if _ring_call(sub, "release"):
                release_receivers = True
                end = getattr(sub, "end_lineno", sub.lineno) or sub.lineno
                for a in sub.args:
                    if isinstance(a, ast.Name):
                        released.setdefault(a.id, end)
            chain = _attr_chain(sub.func)
            argnums = census.donating.get(chain[-1] if chain else "")
            for i in argnums or ():
                if i < len(sub.args) and isinstance(sub.args[i], ast.Name):
                    donated_names.add(sub.args[i].id)
        if isinstance(sub, ast.Return) and sub.value is not None:
            for n2 in ast.walk(sub.value):
                if isinstance(n2, ast.Name):
                    returned.add(n2.id)

    for name, line in sorted(acquired.items()):
        if name in released or name in donated_names or name in returned:
            continue
        # `for oc in outs: ring.release(oc)` — releasing through a loop
        # variable still proves intent; only a function with NO release
        # call on a ring receiver trips
        if release_receivers:
            continue
        findings.append(
            Finding(
                rule="slot-lifecycle",
                key=f"{module}:{qual}:{name}",
                message=(
                    f"{module}:{qual} acquires staging slot {name!r} but "
                    f"never releases it, launches into it, or returns it — "
                    f"the ring leaks one slot per call"
                ),
                file=module,
                line=line,
            )
        )

    for name, line in released.items():
        for sub in ast.walk(node):
            if (
                isinstance(sub, ast.Name)
                and sub.id == name
                and isinstance(sub.ctx, ast.Load)
                and sub.lineno > line
            ):
                findings.append(
                    Finding(
                        rule="read-after-donate",
                        key=f"{module}:{qual}:{name}:release",
                        message=(
                            f"{module}:{qual} reads {name!r} at line "
                            f"{sub.lineno} after releasing it to its ring at "
                            f"line {line} — the next hop's launch may "
                            f"overwrite the slot"
                        ),
                        file=module,
                        line=sub.lineno,
                    )
                )
                break
    return findings


def run_dispatch_under_lock(graph) -> List[Finding]:
    """Device-dispatch-under-lock: consume the lockgraph's held-set call
    sites (its walker already threads lock context through every call)
    and flag fused-kernel dispatch, kernel launches and syncs under a
    package lock."""
    findings: List[Finding] = []
    for key, info in graph.funcs.items():
        module, _, fname = key
        for c in info.calls:
            if not c.held:
                continue
            if not (
                c.leaf in DEVICE_DISPATCH_LEAFS or "kernel" in c.leaf.lower()
            ):
                continue
            lockset = ",".join(c.held)
            findings.append(
                Finding(
                    rule="device-dispatch-under-lock",
                    key=f"{module}:{fname}:{c.leaf}:{lockset}",
                    message=(
                        f"{module}:{fname} dispatches device work "
                        f"({c.leaf}) while holding [{lockset}] — the lock is "
                        f"pinned for the whole device round trip"
                    ),
                    file=module,
                    line=c.line,
                )
            )
    return findings
