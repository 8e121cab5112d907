"""Native transport engine bindings (ctypes over engine.cpp).

Port of the JAX package's ``native/__init__.py``.  The engine is the
C++ analog of the reference's core IO loops (input_messenger.cpp:317-382,
socket.cpp:1584-1790): an epoll server whose framing/dispatch cycle
never touches the GIL, with a built-in native echo fast path and a
Python callback for everything else, plus a pooled-connection client
and a multiplexed reactor client whose round trips run with the GIL
released.  ``engine.cpp`` and ``fastcall.c`` are the JAX package's
sources byte for byte; they contain nothing of JAX.

Where the port differs from the JAX package:

- **The build.**  ``engine.cpp`` compiles with ``g++`` and
  ``fastcall.c`` (a CPython extension) with ``gcc`` on first use, into
  ``_build/`` beside this file, each target named by a hash of its
  source, its flags and, for the extension, the interpreter it is built
  for.  Each process
  compiles into a temporary of its own and renames it into place, so
  concurrent first users (test workers, several interpreters) never
  race on a shared file; in one process a guard makes concurrent first
  callers wait for one build.  Nothing is downloaded.
- **No fallback that hides the engine.**  When the engine cannot be
  built or loaded, everything that needs it raises ``NativeEngineError``
  carrying the compiler's (or the loader's) message; the JAX package
  degrades to its Python transport instead.  ``available()`` still
  answers without raising.
- **The call boundary is exposed.**  ``fastcall.c`` is optional, as in
  the JAX package: without it the client paths cross into C through
  ctypes.  ``call_boundary()`` says which boundary runs and why.
- **The extension's module name.**  The extension loads as
  ``incubator_brpc_tpu_torch.native._fastcall``, so it never shares a
  ``sys.modules`` entry with the JAX package's ``_fastcall``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import sys
import threading
from typing import Callable, Optional

from incubator_brpc_tpu_torch.utils import sanitize_flags as _sanitize_flags

_HERE = pathlib.Path(__file__).resolve().parent
_SRC = _HERE / "engine.cpp"
_FC_SRC = _HERE / "fastcall.c"
BUILD_DIR = _HERE / "_build"

# Sanitizer build modes: the env var selects instrumented flags (and so
# another target hash).  Loading an ASan/TSan library into a stock
# CPython additionally needs the runtime preloaded — see
# sanitizer_preload(); without it the load fails and the engine is
# unavailable (NativeEngineError), exactly like a missing toolchain.
SANITIZE = _sanitize_flags.check_mode(_sanitize_flags.SANITIZE)
_SAN_FLAGS = _sanitize_flags.SAN_FLAGS
ENGINE_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
                *_SAN_FLAGS[SANITIZE]]
FASTCALL_FLAGS = ["-O2", "-shared", "-fPIC", *_SAN_FLAGS[SANITIZE]]
BUILD_TIMEOUT_S = 300


class NativeEngineError(RuntimeError):
    """The C++ engine could not be built or loaded; the message carries
    the compiler's or the loader's output."""


def sanitizer_preload(mode: Optional[str] = None) -> Optional[str]:
    """The LD_PRELOAD value a subprocess needs to load the engine
    sanitized under `mode` (defaults to this process's SANITIZE):
    colon-separated runtime libs, or None when not sanitizing or the
    toolchain lacks ANY of the required runtimes — every component is
    existence-checked so a toolchain with libasan but no libubsan is a
    loud None, not a lane that silently loses its native coverage."""
    mode = SANITIZE if mode is None else mode
    if not mode:
        return None
    libs = ["libasan.so", "libubsan.so"] if mode == "asan" else ["libtsan.so"]
    out = []
    for lib in libs:
        try:
            proc = subprocess.run(
                ["g++", f"-print-file-name={lib}"],
                capture_output=True, text=True, timeout=10,
            )
            path = proc.stdout.strip()
            if not path or os.path.sep not in path or not os.path.exists(path):
                return None  # this runtime is missing: the mode can't run
            out.append(path)
        except Exception:  # noqa: BLE001
            return None
    return ":".join(out)

_lib = None
_lib_err: Optional[str] = None
_fastcall = None  # CPython extension module (fastcall.c), or None
_fastcall_err: Optional[str] = None  # why the ctypes boundary runs
_build_lock = threading.Lock()

# Tag bit that routes a mux completion to the RING lane (engine.cpp
# kRingTagBit): ring windows harvest via nc_mux_harvest and must never
# be drained by the channel's background nc_mux_poll harvester.
RING_TAG_BIT = 1 << 63

# Hard per-window cap (fastcall.c RING_WINDOW_MAX / POLL_BATCH): the
# client ring chunks larger windows itself.
RING_WINDOW_MAX = 1024
RING_HARVEST_MAX = 128


class NcResponse(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("body_len", ctypes.c_uint64),
        ("attachment_size", ctypes.c_uint64),
        ("error_code", ctypes.c_int32),
        ("compress_type", ctypes.c_int32),
        ("error_text", ctypes.c_char * 240),
    ]


class MuxCompletion(ctypes.Structure):
    _fields_ = [
        ("tag", ctypes.c_uint64),
        ("rc", ctypes.c_int32),
        ("error_code", ctypes.c_int32),
        ("compress_type", ctypes.c_int32),
        ("attachment_size", ctypes.c_uint32),
        ("body_len", ctypes.c_uint64),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("error_text", ctypes.c_char * 96),
    ]


class NcBenchResult(ctypes.Structure):
    _fields_ = [
        ("ok", ctypes.c_uint64),
        ("failed", ctypes.c_uint64),
        ("qps", ctypes.c_double),
        ("p50_us", ctypes.c_double),
        ("p99_us", ctypes.c_double),
        ("p999_us", ctypes.c_double),
        ("avg_us", ctypes.c_double),
    ]


DISPATCH_CB = ctypes.CFUNCTYPE(
    None, ctypes.c_uint64, ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8),
    ctypes.c_uint64
)

# ConnProto values (engine.cpp): which wire protocol a fallback frame
# arrived on — sniffed per connection from its first bytes
PROTO_TPU_STD = 1
PROTO_HTTP = 2
PROTO_REDIS = 3

# Generic native-method handler ABI (engine.cpp NativeMethodFn): return
# <0 declines the frame to the Python fallback, >=0 is the response
# error_code.  Response bytes go through resp_append_payload/attachment
# on the opaque resp_ctx.  Handlers may be real native pointers (zero
# GIL) or ctypes callbacks (generic but GIL-bound).
NATIVE_METHOD_FN = ctypes.CFUNCTYPE(
    ctypes.c_int32,
    ctypes.c_void_p,                 # user_data
    ctypes.POINTER(ctypes.c_uint8),  # req
    ctypes.c_uint64,                 # req_len
    ctypes.POINTER(ctypes.c_uint8),  # att
    ctypes.c_uint64,                 # att_len
    ctypes.c_void_p,                 # resp_ctx
)


def bench_echo(
    host: str,
    port: int,
    payload_len: int = 4096,
    concurrency: int = 8,
    duration_ms: int = 3000,
    depth: int = 1,
    conns: int = 1,
    service: str = "EchoService",
    method: str = "Echo",
) -> dict:
    """Native load generator (the rpc_press engine; the reference's
    tools/rpc_press is likewise native). depth>1 pipelines that many
    in-flight RPCs per worker over a mux client with `conns`
    connections."""
    require()
    res = NcBenchResult()
    _lib.nc_bench_echo(
        host.encode(), port, service.encode(), method.encode(),
        payload_len, concurrency, duration_ms, depth, conns,
        ctypes.byref(res),
    )
    return {
        "ok": res.ok,
        "failed": res.failed,
        "qps": round(res.qps, 1),
        "p50_us": res.p50_us,
        "p99_us": res.p99_us,
        "p999_us": res.p999_us,
        "avg_us": round(res.avg_us, 1),
    }


def bench_http(
    host: str,
    port: int,
    path: str = "/echo",
    payload_len: int = 4096,
    concurrency: int = 2,
    duration_ms: int = 2000,
    depth: int = 16,
) -> dict:
    """Native pipelined HTTP/1.1 load generator (keep-alive POSTs)."""
    require()
    res = NcBenchResult()
    _lib.nc_bench_http(
        host.encode(), port, path.encode(), payload_len, concurrency,
        duration_ms, depth, ctypes.byref(res),
    )
    return {
        "ok": res.ok, "failed": res.failed, "qps": round(res.qps, 1),
        "p50_us": res.p50_us, "p99_us": res.p99_us, "p999_us": res.p999_us,
        "avg_us": round(res.avg_us, 1),
    }


def bench_redis(
    host: str,
    port: int,
    value_len: int = 64,
    concurrency: int = 2,
    duration_ms: int = 2000,
    depth: int = 16,
) -> dict:
    """Native pipelined redis load generator (alternating SET/GET;
    each command counts as one op)."""
    require()
    res = NcBenchResult()
    _lib.nc_bench_redis(
        host.encode(), port, value_len, concurrency, duration_ms, depth,
        ctypes.byref(res),
    )
    return {
        "ok": res.ok, "failed": res.failed, "qps": round(res.qps, 1),
        "p50_us": res.p50_us, "p99_us": res.p99_us, "p999_us": res.p999_us,
        "avg_us": round(res.avg_us, 1),
    }


def require():
    """Load the engine (building it on first use) or raise
    NativeEngineError with the reason."""
    _load()
    if _lib is None:
        raise NativeEngineError(f"native engine unavailable: {_lib_err}")


def _target(stem: str, src: pathlib.Path, cmd_key: str) -> pathlib.Path:
    digest = hashlib.sha256(src.read_bytes() + cmd_key.encode()).hexdigest()
    return BUILD_DIR / f"{stem}-{digest[:16]}.so"


def _compile(cmd, target: pathlib.Path) -> None:
    """Run ``cmd + [-o tmp]`` and rename tmp onto target; raises
    NativeEngineError with the compiler's message.  The temporary is
    this process's own, and the rename is atomic: a concurrent builder
    of the same target in another process sees all or nothing."""
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    try:
        proc = subprocess.run(
            [*cmd, "-o", str(tmp)], capture_output=True, text=True,
            timeout=BUILD_TIMEOUT_S,
        )
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        raise NativeEngineError(f"{cmd[0]} could not run: {e!r}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise NativeEngineError(
            f"{cmd[0]} failed ({proc.returncode}): {proc.stderr[-1600:]}"
        )
    os.replace(tmp, target)


def engine_path() -> pathlib.Path:
    return _target("libengine", _SRC, "g++ " + " ".join(ENGINE_FLAGS))


def fastcall_path() -> pathlib.Path:
    import sysconfig

    inc = sysconfig.get_paths()["include"]
    key = f"gcc {' '.join(FASTCALL_FLAGS)} -I{inc} {sys.version} {sys.platform}"
    return _target("fastcall", _FC_SRC, key)


def _build() -> pathlib.Path:
    """Compile engine.cpp unless its hash-named target exists."""
    target = engine_path()
    if not target.exists():
        _compile(["g++", *ENGINE_FLAGS, str(_SRC)], target)
    return target


def _build_fastcall() -> pathlib.Path:
    """Compile fastcall.c (CPython extension) unless built."""
    import sysconfig

    target = fastcall_path()
    if not target.exists():
        inc = sysconfig.get_paths()["include"]
        _compile(["gcc", *FASTCALL_FLAGS, f"-I{inc}", str(_FC_SRC)], target)
    return target


def _load_fastcall(lib) -> None:
    """Import the extension and inject the engine's entry points
    (resolved from the already-loaded engine — no link dependency).
    Optional: without it the ctypes boundary runs, and
    ``call_boundary()`` says why."""
    global _fastcall, _fastcall_err
    try:
        path = _build_fastcall()
        import importlib.util

        # a dotted name: the init symbol is still PyInit__fastcall, and
        # sys.modules never confuses it with the JAX package's _fastcall
        spec = importlib.util.spec_from_file_location(
            f"{__name__}._fastcall", str(path)
        )
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.setup(
            ctypes.cast(lib.nc_mux_call, ctypes.c_void_p).value,
            ctypes.cast(lib.nc_mux_submit, ctypes.c_void_p).value,
            ctypes.cast(lib.nc_mux_poll, ctypes.c_void_p).value,
            ctypes.cast(lib.nc_mux_submit_many, ctypes.c_void_p).value,
            ctypes.cast(lib.nc_mux_harvest, ctypes.c_void_p).value,
            ctypes.cast(lib.ns_send_burst, ctypes.c_void_p).value,
        )
        _fastcall = mod
    except Exception as e:  # noqa: BLE001 — the ctypes boundary covers it
        _fastcall = None
        _fastcall_err = f"{type(e).__name__}: {e}"


def call_boundary() -> tuple:
    """(boundary, why): ``("fastcall", None)`` when the CPython
    extension carries the client calls, else ``("ctypes", reason)``.
    Loads the engine first (raising NativeEngineError without it)."""
    require()
    if _fastcall is not None:
        return "fastcall", None
    return "ctypes", _fastcall_err


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return
    with _build_lock:
        if _lib is not None or _lib_err is not None:
            return
        try:
            lib = ctypes.CDLL(str(_build()))
        except NativeEngineError as e:
            _lib_err = str(e)
            return
        except OSError as e:
            _lib_err = f"dlopen failed: {e}"
            return
        lib.ns_create.restype = ctypes.c_void_p
        lib.ns_set_dispatch.argtypes = [ctypes.c_void_p, DISPATCH_CB]
        lib.ns_register_native_echo.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.ns_register_native_method.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            NATIVE_METHOD_FN, ctypes.c_void_p,
        ]
        lib.ns_resp_append_payload.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.ns_resp_append_attachment.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.ns_set_method_max_concurrency.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32,
        ]
        lib.ns_method_stats.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ns_method_stats.restype = ctypes.c_int
        lib.ns_listen.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.ns_listen.restype = ctypes.c_int
        lib.ns_set_fault.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint32,
            ctypes.c_uint64, ctypes.c_longlong,
        ]
        lib.ns_clear_faults.argtypes = []
        lib.ns_fault_hits.argtypes = [ctypes.c_int]
        lib.ns_fault_hits.restype = ctypes.c_uint64
        lib.ns_enable_protocols.argtypes = [ctypes.c_void_p, ctypes.c_uint32]
        lib.ns_register_native_http.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, NATIVE_METHOD_FN,
            ctypes.c_void_p,
        ]
        lib.ns_register_native_http_echo.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p,
        ]
        lib.ns_redis_enable_native_kv.argtypes = [ctypes.c_void_p]
        lib.nc_bench_http.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(NcBenchResult),
        ]
        lib.nc_bench_http.restype = ctypes.c_int
        lib.nc_bench_redis.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(NcBenchResult),
        ]
        lib.nc_bench_redis.restype = ctypes.c_int
        lib.ns_send.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
        ]
        lib.ns_send.restype = ctypes.c_int
        lib.ns_send_burst.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int,
        ]
        lib.ns_send_burst.restype = ctypes.c_int
        lib.ns_ring_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.ns_close_conn.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.ns_py_done.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.ns_stop.argtypes = [ctypes.c_void_p]
        lib.ns_destroy.argtypes = [ctypes.c_void_p]
        lib.nc_pool_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.nc_pool_create.restype = ctypes.c_void_p
        lib.nc_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.nc_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.nc_call.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(NcResponse),
        ]
        lib.nc_call.restype = ctypes.c_int
        lib.nc_mux_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ]
        lib.nc_mux_create.restype = ctypes.c_void_p
        lib.nc_mux_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_uint64,
        ]
        lib.nc_mux_submit.restype = ctypes.c_uint64
        lib.nc_mux_poll.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(MuxCompletion), ctypes.c_int,
            ctypes.c_int,
        ]
        lib.nc_mux_poll.restype = ctypes.c_int
        lib.nc_mux_submit_many.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_int, ctypes.c_int,
            ctypes.c_uint64,
        ]
        lib.nc_mux_submit_many.restype = ctypes.c_int
        lib.nc_mux_harvest.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(MuxCompletion), ctypes.c_int,
            ctypes.c_int,
        ]
        lib.nc_mux_harvest.restype = ctypes.c_int
        lib.nc_mux_ring_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.nc_mux_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.nc_mux_call.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t,
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64,
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p,
            ctypes.c_uint64, ctypes.c_int, ctypes.POINTER(NcResponse),
        ]
        lib.nc_mux_call.restype = ctypes.c_int
        lib.nc_mux_destroy.argtypes = [ctypes.c_void_p]
        lib.nc_bench_echo.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(NcBenchResult),
        ]
        lib.nc_bench_echo.restype = ctypes.c_int
        _load_fastcall(lib)
        _lib = lib


def available() -> bool:
    _load()
    return _lib is not None


# ---- fault injection (chaos/), process-wide engine knobs ----
# Site ids / action codes mirror engine.cpp FaultSite / FaultAction;
# chaos/injector.py owns the name → id mapping.

def set_fault(site: int, action: int, arg: int, prob_u32: int, seed: int,
              max_hits: int = -1) -> None:
    """Program one native injection site (engine.cpp ns_set_fault).
    The decision is deterministic: fmix64(seed + n*golden) per traversal
    n, firing when the high 32 bits fall under prob_u32."""
    require()
    _lib.ns_set_fault(site, action, arg, prob_u32, seed, max_hits)


def clear_faults() -> None:
    _load()
    if _lib is not None:
        _lib.ns_clear_faults()


def fault_hits(site: int) -> int:
    _load()
    if _lib is None:
        return 0
    return int(_lib.ns_fault_hits(site))


def unavailable_reason() -> Optional[str]:
    _load()
    return _lib_err


class NativeServerEngine:
    """Owns one C++ server instance: listener + worker threads."""

    def __init__(self, nworkers: int = 4):
        require()
        self._h = _lib.ns_create()
        self._nworkers = nworkers
        self._cb_ref = None  # keep the CFUNCTYPE alive
        self.port = 0
        self._stopped = False

    def set_dispatch(self, fn: Callable[[int, int, bytes], None]):
        """fn(conn_id, proto, frame_bytes) — called from engine worker
        threads for frames the native fast path doesn't handle.  proto
        is PROTO_TPU_STD / PROTO_HTTP / PROTO_REDIS."""

        def _trampoline(conn_id, proto, data, length):
            try:
                fn(conn_id, proto, ctypes.string_at(data, length))
            except Exception:  # noqa: BLE001 — never unwind into C
                pass

        self._cb_ref = DISPATCH_CB(_trampoline)
        _lib.ns_set_dispatch(self._h, self._cb_ref)

    def register_native_echo(self, service: str, method: str, attach_echo: bool):
        _lib.ns_register_native_echo(
            self._h, service.encode(), method.encode(), 1 if attach_echo else 0
        )

    def register_native_method(self, service: str, method: str, handler):
        """Generic native dispatch: `handler(user_data, req, req_len,
        att, att_len, resp_ctx)` returns <0 to decline (frame falls to
        the Python dispatch) or the response error_code (0 = ok).
        Accepts a raw C function pointer (zero-GIL) or a Python callable
        (wrapped in a ctypes callback: generic, GIL-bound).  Use
        resp_append_payload/resp_append_attachment to build the
        response.  Must be called before listen()."""
        if not isinstance(handler, NATIVE_METHOD_FN):
            py_handler = handler

            def _safe(ud, req, rl, att, al, ctx, _h=py_handler):
                # A raising Python handler must NOT look like success
                # (ctypes would return 0 and the engine would ship a
                # partial payload as ok): decline to the Python fallback
                try:
                    return _h(ud, req, rl, att, al, ctx)
                except Exception:  # noqa: BLE001 — never unwind into C
                    return -1

            handler = NATIVE_METHOD_FN(_safe)
        # keep callback objects alive for the engine's lifetime
        if not hasattr(self, "_method_refs"):
            self._method_refs = []
        self._method_refs.append(handler)
        _lib.ns_register_native_method(
            self._h, service.encode(), method.encode(), handler, None
        )

    @staticmethod
    def resp_append_payload(resp_ctx, data: bytes):
        _lib.ns_resp_append_payload(resp_ctx, data, len(data))

    @staticmethod
    def resp_append_attachment(resp_ctx, data: bytes):
        _lib.ns_resp_append_attachment(resp_ctx, data, len(data))

    def set_method_max_concurrency(self, service: str, method: str, limit: int):
        _lib.ns_set_method_max_concurrency(
            self._h, service.encode(), method.encode(), int(limit)
        )

    def method_stats(self, service: str, method: str):
        """Cumulative fast-path counters for a registered native method:
        {count, latency_ns_sum, rejected, errors}, or None if the method
        isn't native.  The server harvests deltas into MethodStatus so
        /status includes fast-path traffic."""
        out = (ctypes.c_uint64 * 4)()
        rc = _lib.ns_method_stats(
            self._h, service.encode(), method.encode(), out
        )
        if rc != 0:
            return None
        return {
            "count": out[0],
            "latency_ns_sum": out[1],
            "rejected": out[2],
            "errors": out[3],
        }

    def enable_protocols(self, *, http: bool = False, redis: bool = False):
        """Allow extra wire protocols on this port (sniffed per
        connection; tpu_std always on).  Call before listen()."""
        mask = 0
        if http:
            mask |= 1 << PROTO_HTTP
        if redis:
            mask |= 1 << PROTO_REDIS
        if mask:
            _lib.ns_enable_protocols(self._h, mask)

    def register_native_http_echo(self, path: str):
        """Serve `path` natively: response body = request body (the
        reference http_server example's trivial echo handler, in C)."""
        _lib.ns_register_native_http_echo(self._h, path.encode())

    def redis_enable_native_kv(self):
        """Answer GET/SET/DEL/EXISTS/INCR/PING from the engine's
        sharded in-memory KV; other commands still reach the Python
        RedisService.  The KV store lives in C — Python handlers do
        not see natively-stored keys."""
        _lib.ns_redis_enable_native_kv(self._h)

    def listen(self, port: int = 0, host: str = "0.0.0.0") -> int:
        rc = _lib.ns_listen(self._h, host.encode(), port, self._nworkers)
        if rc < 0:
            raise OSError(-rc, os.strerror(-rc))
        self.port = rc
        return rc

    def send(self, conn_id: int, frame: bytes) -> int:
        if self._h is None or self._stopped:
            return -1
        return _lib.ns_send(self._h, conn_id, frame, len(frame))

    def send_burst(self, conn_id: int, frames) -> int:
        """Flush one harvested window of response frames for a
        connection as ONE writev burst (server response ring,
        ns_send_burst).  frames is a sequence of bytes objects; they
        are only borrowed for the duration of the call."""
        if self._h is None or self._stopped:
            return -1
        n = len(frames)
        if n == 0:
            return 0
        if n == 1:
            return _lib.ns_send(self._h, conn_id, frames[0], len(frames[0]))
        fc = _fastcall
        if fc is not None:
            burst = getattr(fc, "srv_send_burst", None)
            if burst is not None:
                if not isinstance(frames, list):
                    frames = list(frames)
                return burst(self._h, conn_id, frames)
        ptrs = (ctypes.c_char_p * n)(*frames)
        lens = (ctypes.c_uint64 * n)(*[len(f) for f in frames])
        return _lib.ns_send_burst(self._h, conn_id, ptrs, lens, n)

    def ring_stats(self):
        """Server response-ring step log: {windows, responses,
        flush_bursts}.  Counts, never timing — windows counts
        send_burst flushes, flush_bursts counts writev bursts (native
        read cycles + ring flushes)."""
        out = (ctypes.c_uint64 * 3)()
        _lib.ns_ring_stats(self._h, out)
        return {
            "windows": out[0],
            "responses": out[1],
            "flush_bursts": out[2],
        }

    def close_conn(self, conn_id: int):
        if self._h is None or self._stopped:
            return
        _lib.ns_close_conn(self._h, conn_id)

    def py_done(self, conn_id: int):
        """Signal that Python answered one dispatched http/redis
        frame: the engine resumes cutting/reading the connection.
        MUST be called exactly once per PROTO_HTTP/PROTO_REDIS
        dispatch, or the connection stays paused forever."""
        if self._h is None or self._stopped:
            return
        _lib.ns_py_done(self._h, conn_id)

    def stop(self):
        if self._stopped:
            return
        self._stopped = True
        _lib.ns_stop(self._h)

    def destroy(self):
        # stop only — the C object is deliberately NOT freed: late
        # Python fallback tasks may still hold this engine and call
        # send()/close_conn() concurrently, and ns_stop already released
        # every heavy resource (threads, epoll fds, connections). The
        # handful of bytes left per server lifetime is the safe trade.
        self.stop()


class NativeClientPool:
    """Pooled-connection client: one in-flight RPC per fd, GIL released
    for the whole round trip (the pooled connection_type of
    channel.h:84-89, natively).

    Channel's sync path now rides NativeMuxClient.call_blocking (many
    callers multiplexed over few connections); this pool remains the
    exclusive-fd primitive — simpler isolation semantics, used by tests
    and available to tools that want one-request-per-connection."""

    def __init__(self, host: str, port: int, connect_timeout_ms: int = 3000):
        require()
        self._h = _lib.nc_pool_create(host.encode(), port, connect_timeout_ms)
        self.host = host
        self.port = port
        self._tls = threading.local()  # per-thread NcResponse reuse
        self._call = _lib.nc_call
        self._free = _lib.nc_free

    def call(
        self,
        service,
        method,
        payload: bytes,
        attachment: bytes = b"",
        timeout_ms: int = -1,
        log_id: int = 0,
    ):
        """→ (rc, body_bytes, attachment_size, error_code, error_text).
        rc 0 = transport ok (error_code may still be an app error).
        service/method accept str or pre-encoded bytes (hot path)."""
        tls = self._tls
        resp = getattr(tls, "resp", None)
        if resp is None:
            resp = tls.resp = NcResponse()
            tls.ref = ctypes.byref(resp)
        rc = self._call(
            self._h,
            service if isinstance(service, bytes) else service.encode(),
            method if isinstance(method, bytes) else method.encode(),
            log_id,
            payload,
            len(payload),
            attachment,
            len(attachment),
            timeout_ms,
            tls.ref,
        )
        if rc != 0:
            return rc, b"", 0, 0, "", 0
        try:
            body = ctypes.string_at(resp.data, resp.body_len)
        finally:
            if resp.data:
                self._free(resp.data)
        ec = resp.error_code
        return (
            0,
            body,
            resp.attachment_size,
            ec,
            resp.error_text.decode("utf-8", "replace") if ec else "",
            resp.compress_type,
        )

    def destroy(self):
        if self._h:
            _lib.nc_pool_destroy(self._h)
            self._h = None


class NativeMuxClient:
    """Multiplexed async client: many in-flight RPCs over a few
    connections, submissions batched into single writes by a C++
    reactor, completions harvested in batches by one Python thread.
    The async-CallMethod data path (reference: done!=NULL CallMethod)."""

    def __init__(self, host: str, port: int, nconns: int = 2):
        require()
        self._h = _lib.nc_mux_create(host.encode(), port, nconns)
        # tag allocation + pending registry are lock-free: itertools
        # .count's __next__ and single dict ops are atomic under the
        # GIL, and registration strictly precedes submission so the
        # harvester's pop always finds its entry
        import itertools

        self._pending = {}  # tag -> (handler, ctx) | legacy closure
        self._tag_iter = itertools.count(1)
        # ring tags need BLOCK reservation (tag_base..tag_base+n-1), so
        # unlike _tag_iter they take a small lock; the lock is per
        # window, not per call
        self._ring_lock = threading.Lock()
        self._ring_next = 1
        # cross-ring routing: all SubmissionRings on this mux share ONE
        # C-side completion lane, so a ring harvesting the lane may pull
        # a sibling ring's completion — it parks the tuple here (under
        # _ring_lock) for the owner's next harvest instead of dropping
        # it.  _ring_zombie holds tags whose slot a drain backstop
        # already failed: their late completions are discarded.
        self._ring_stash = {}
        self._ring_zombie = set()
        # leader/follower harvest: only ONE ring blocks in the C lane
        # at a time (holder of _ring_harvest_lock); the others wait on
        # _ring_stash_cv, which the leader notifies whenever it parks a
        # sibling's completion — without this, a follower would sit out
        # the leader's full harvest timeout with its results already in
        # the stash
        self._ring_harvest_lock = threading.Lock()
        self._ring_stash_cv = threading.Condition(self._ring_lock)
        self._stop = False
        # fast paths: the C extension's entry points if built (≈0.3us
        # GIL-held per call), else prebound ctypes fallbacks
        self._fc_call = _fastcall.mux_call if _fastcall is not None else None
        self._fc_submit = (
            _fastcall.mux_submit if _fastcall is not None else None
        )
        self._ct_call = _lib.nc_mux_call
        self._tls = threading.local()  # per-thread NcResponse (ctypes path)
        self._harvester = threading.Thread(
            target=self._harvest_loop, daemon=True, name="nc-mux-harvest"
        )
        self._harvester.start()

    def fast_call_entry(self):
        """The leanest callable for one sync RPC — signature
        (service, method, payload, attachment, timeout_ms, log_id).
        With the extension built this is mux_call_fast pre-bound to the
        reactor handle via functools.partial (C-level __call__, no
        Python frame): it returns the response body BYTES directly for
        the common shape and the 6-tuple otherwise.  Without the
        extension it is the ctypes call_blocking wrapper (tuple only —
        callers type-check for bytes, so both contracts compose)."""
        if self._fc_call is not None:
            import functools

            fast = getattr(_fastcall, "mux_call_fast", None)
            return functools.partial(
                fast if fast is not None else self._fc_call, self._h
            )
        return self.call_blocking

    def call_blocking(
        self,
        service: bytes,
        method: bytes,
        payload: bytes,
        attachment: bytes = b"",
        timeout_ms: int = -1,
        log_id: int = 0,
    ):
        """One SYNC RPC multiplexed over the reactor: the calling thread
        parks in C on a per-call waiter with the GIL released, so many
        sync callers share a few connections and their submissions batch
        into single writes.  → (rc, body|None, att_size, error_code,
        error_text|None, compress_type)."""
        fc = self._fc_call
        if fc is not None:
            return fc(
                self._h, service, method, payload, attachment, timeout_ms,
                log_id,
            )
        tls = self._tls
        resp = getattr(tls, "resp", None)
        if resp is None:
            resp = tls.resp = NcResponse()
            tls.ref = ctypes.byref(resp)
        rc = self._ct_call(
            self._h, service, len(service), method, len(method), log_id,
            payload, len(payload), attachment, len(attachment), timeout_ms,
            tls.ref,
        )
        if rc != 0:
            return rc, None, 0, 0, None, 0
        try:
            body = ctypes.string_at(resp.data, resp.body_len)
        finally:
            if resp.data:
                _lib.nc_free(resp.data)
        ec = resp.error_code
        return (
            0,
            body,
            resp.attachment_size,
            ec,
            resp.error_text.decode("utf-8", "replace") if ec else None,
            resp.compress_type,
        )

    def submit(
        self,
        service,
        method,
        payload: bytes,
        attachment: bytes,
        timeout_ms: int,
        on_complete,
        log_id: int = 0,
    ) -> bool:
        """on_complete(rc, body, att_size, error_code, error_text,
        compress_type) runs on the harvester thread."""
        tag = next(self._tag_iter)
        self._pending[tag] = on_complete
        cid = _lib.nc_mux_submit(
            self._h,
            service if isinstance(service, bytes) else service.encode(),
            method if isinstance(method, bytes) else method.encode(),
            log_id,
            payload,
            len(payload),
            attachment,
            len(attachment),
            timeout_ms,
            tag,
        )
        if not cid:
            self._pending.pop(tag, None)
            return False
        return True

    def submit_ctx(
        self,
        service: bytes,
        method: bytes,
        payload: bytes,
        attachment: bytes,
        timeout_ms: int,
        log_id: int,
        handler,
        ctx,
    ) -> bool:
        """Closure-free async submit: on completion the harvester calls
        ``handler(ctx, rc, body, att_size, ec, etext, ctype)``.  handler
        should be a stable bound method; ctx carries the per-call state
        (one tuple/list instead of two closures — the per-call GIL cost
        is what bounds aggregate qps)."""
        tag = next(self._tag_iter)
        self._pending[tag] = (handler, ctx)
        fc = self._fc_submit
        if fc is not None:
            cid = fc(
                self._h, service, method, payload, attachment, timeout_ms,
                log_id, tag,
            )
        else:
            cid = _lib.nc_mux_submit(
                self._h, service, method, log_id, payload, len(payload),
                attachment, len(attachment), timeout_ms, tag,
            )
        if not cid:
            self._pending.pop(tag, None)
            return False
        return True

    def _poll_batch_ctypes(self):
        """ctypes fallback for the extension's mux_poll: one batch of
        completions normalized to the SAME tuple shape, so the harvest
        loop has exactly one dispatch implementation."""
        batch = getattr(self, "_ct_batch", None)
        if batch is None:
            batch = self._ct_batch = (MuxCompletion * 128)()
        n = _lib.nc_mux_poll(self._h, batch, 128, 200)
        out = []
        for i in range(n):
            c = batch[i]
            body = None
            if c.data:
                try:
                    if c.rc == 0:
                        body = ctypes.string_at(c.data, c.body_len)
                finally:
                    _lib.nc_free(c.data)
            etext = (
                c.error_text.decode("utf-8", "replace")
                if c.error_code
                else None
            )
            out.append(
                (c.tag, c.rc, body, c.attachment_size, c.error_code,
                 etext, c.compress_type)
            )
        return out

    # ---- submission/completion ring (io_uring-style windows) ----

    def reserve_ring_tags(self, n: int) -> int:
        """Reserve a contiguous block of n ring-lane tags; returns
        tag_base (RING_TAG_BIT set — the engine routes these completions
        to the ring queue, invisible to the background harvester)."""
        with self._ring_lock:
            base = self._ring_next
            self._ring_next += n
        return RING_TAG_BIT | base

    def submit_window(
        self,
        service: bytes,
        method: bytes,
        payloads,
        timeout_ms: int,
        log_id: int,
        tag_base: int,
    ) -> int:
        """Stage a window of same-method calls in ONE boundary crossing
        (extension mux_submit_many; ctypes array fallback).  Returns the
        number staged — k < len(payloads) means slots k.. were NOT
        staged and the caller must fail them."""
        fc = _fastcall
        if fc is not None and hasattr(fc, "mux_submit_many"):
            return fc.mux_submit_many(
                self._h, service, method, payloads, timeout_ms, log_id,
                tag_base,
            )
        n = len(payloads)
        ptrs = (ctypes.c_char_p * n)(*payloads)
        lens = (ctypes.c_uint64 * n)(*[len(p) for p in payloads])
        return _lib.nc_mux_submit_many(
            self._h, service, method, log_id, ptrs, lens, n, timeout_ms,
            tag_base,
        )

    def harvest_window(self, timeout_ms: int, ring) -> int:
        """Harvest up to min(len(ring), 128) ring-lane completions into
        the caller's PREALLOCATED ring (list of 7-slot lists), blocking
        up to timeout_ms for the first.  Slot layout: [tag, rc,
        body|None, att_size, error_code, error_text|None, ctype]."""
        fc = _fastcall
        if fc is not None and hasattr(fc, "mux_harvest"):
            return fc.mux_harvest(self._h, timeout_ms, ring)
        batch = getattr(self, "_ct_ring_batch", None)
        if batch is None:
            batch = self._ct_ring_batch = (MuxCompletion * RING_HARVEST_MAX)()
        max_n = min(len(ring), RING_HARVEST_MAX)
        n = _lib.nc_mux_harvest(self._h, batch, max_n, timeout_ms)
        for i in range(n):
            c = batch[i]
            body = None
            if c.data:
                try:
                    if c.rc == 0:
                        body = ctypes.string_at(c.data, c.body_len)
                finally:
                    _lib.nc_free(c.data)
            slot = ring[i]
            slot[0] = c.tag
            slot[1] = c.rc
            slot[2] = body
            slot[3] = c.attachment_size
            slot[4] = c.error_code
            slot[5] = (
                c.error_text.decode("utf-8", "replace")
                if c.error_code
                else None
            )
            slot[6] = c.compress_type
        return n

    def ring_stats(self):
        """C-side ring step-log counters: {windows, calls, harvests,
        completions}.  A degraded ring (one crossing per call) shows as
        windows ≈ calls — the bench smoke guard asserts on these."""
        out = (ctypes.c_uint64 * 4)()
        _lib.nc_mux_ring_stats(self._h, out)
        return {
            "windows": out[0],
            "calls": out[1],
            "harvests": out[2],
            "completions": out[3],
        }

    def stats(self):
        """Cumulative sync-call stats kept by the C reactor client:
        {ok, latency_us_sum, latency_us_max, fail}.  latency_us_max is
        windowed — reading it resets the C-side max to 0.  The channel's
        LatencyRecorder harvests deltas of these lazily so the sync
        fast path does zero per-call recorder work in Python."""
        out = (ctypes.c_uint64 * 4)()
        _lib.nc_mux_stats(self._h, out)
        return {
            "ok": out[0],
            "latency_us_sum": out[1],
            "latency_us_max": out[2],
            "fail": out[3],
        }

    def _dispatch_completion(self, tag, rc, body, att_size, ec, etext,
                             ctype):
        """One completion, called from C (mux_poll_dispatch) or from the
        ctypes poll loop.  Exceptions are contained by the caller."""
        cb = self._pending.pop(tag, None)
        if cb is None:
            return
        if type(cb) is tuple:  # (handler, ctx) submit_ctx
            cb[0](cb[1], rc, body, att_size, ec, etext, ctype)
        else:  # legacy closure from submit()
            cb(rc, body if body is not None else b"", att_size, ec,
               etext if etext is not None else "", ctype)

    def _harvest_loop(self):
        fc = _fastcall
        if fc is not None and hasattr(fc, "mux_poll_dispatch"):
            # completion dispatch stays in C: one Python entry per
            # completion (the dispatch itself), no per-batch list and
            # no per-completion tuple.  A raising done() is reported
            # via sys.unraisablehook by the extension and the batch
            # continues.
            h = self._h
            _poll = fc.mux_poll_dispatch
            dispatch = self._dispatch_completion
            while not self._stop:
                _poll(h, 200, dispatch)
            return
        poll = self._poll_batch_ctypes
        while not self._stop:
            for comp in poll():
                try:
                    self._dispatch_completion(*comp)
                except Exception:  # noqa: BLE001 — user done() must
                    pass  # not kill the harvester

    def destroy(self):
        if self._stop:
            return
        self._stop = True
        if threading.current_thread() is self._harvester:
            # called from a done callback: joining ourselves would raise
            # and leak the C reactor — hand cleanup to a helper thread
            threading.Thread(
                target=self._destroy_from_outside, daemon=True
            ).start()
            return
        self._destroy_from_outside()

    def _destroy_from_outside(self):
        self._harvester.join(timeout=2)
        if self._h:
            _lib.nc_mux_destroy(self._h)
            self._h = None
