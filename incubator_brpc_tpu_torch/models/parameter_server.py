"""Parameter-server model family — parameters behind RPC.

Port of the JAX package's ``models/parameter_server.py``: ``PsService``
stores named tensors and serves Get/Put of them, whose payloads ride
IOBuf device segments (a fetch over the ICI transport hands the client
a device-resident ``torch.Tensor``), and the batched ``Forward``
``y = x @ W``: N concurrent calls become ONE padded (bucket, d) @ W
product that streams W once per batch.

Where the port differs from the JAX package:

- **An explicit device.**  ``PsService(device=None)`` keeps its host-
  supplied parameters on the card (chip 0 through the port's
  ``parallel/mesh.py`` helper; with no card and no device it raises).
  ``put_param`` of a numpy array places it there once; the JAX package
  stores the numpy array and lets ``jax.jit`` upload it on every call.
  With a mesh the device defaults to the mesh's first chip's.
  A W that arrives by Put is the tensor the fabric delivered, stored as
  is.
- **The sharded store runs over a single-controller mesh.**
  ``PsService(mesh=)`` over more than one chip row-shards eligible
  matrices into a ``ShardedTensor`` (``parallel/collectives.py``), each
  chip's rows on that chip's device (four virtual chips on one card
  share it), and a batched Forward on a sharded key runs through
  ``batching/sharded.ShardedFusedKernel``: one product per chip and one
  chip-order psum per batch.  ``Get`` of a sharded key attaches the
  assembled W on the service's device, the bytes of the logical
  matrix, as the JAX package's ``append_device`` of a sharded array
  does.  ``make_training_step`` is the dp x tp step on the same mesh,
  differentiated by ``torch.autograd``.  The shard-per-server
  deployment runs too: ``sharded_ps_channel`` fans a Forward out over
  several ``PsService`` servers, and ``scatter_param`` places each
  shard's rows as a tensor on that shard's device, so every Put hop
  runs the copy+checksum kernel.

The product is ``torch.matmul`` in float32 with TF32 off (PyTorch's
default, ``torch.backends.cuda.matmul.allow_tf32 = False``): the JAX
package leaves it to XLA, so it is no TPU kernel and has no
hand-written counterpart.
"""

from __future__ import annotations

import threading
from typing import Dict

import numpy as np
import torch

from incubator_brpc_tpu_torch.batching.fused import FusedKernel, promoted_matmul
from incubator_brpc_tpu_torch.batching.policy import BatchPolicy
from incubator_brpc_tpu_torch.observability.profiling import hbm_account, kernel_section
from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest, EchoResponse
from incubator_brpc_tpu_torch.server.service import (
    Service,
    ServiceStub,
    batched_method,
    rpc_method,
)

# HBM heap profiler hookup (observability/profiling.py): every stored
# device parameter is adopted under this tag.  The handle is resolved at
# import so no store-lock holder ever touches the registry lock.
_PS_ACCT = hbm_account("ps.params")
_NO_CHARGE = (0, 0)


def _hbm_charge(val):
    """Adopt a stored value's device bytes; (bytes, allocs) to remember
    for release at replace/delete.  Host ``bytes`` payloads carry no
    ``.nbytes`` and charge nothing."""
    if isinstance(val, list):
        charges = [_PS_ACCT.adopt(a) for a in val]
        return sum(charges), sum(1 for c in charges if c)
    n = _PS_ACCT.adopt(val)
    return n, (1 if n else 0)


def _hbm_release(charge) -> None:
    nbytes, allocs = charge
    if nbytes:
        _PS_ACCT.release(nbytes, allocs)


def max_servable_dim(per_chip_bytes: int, n_shards: int = 1,
                     dtype_bytes: int = 4) -> int:
    """HBM-ceiling math (docs/sharded_ps.md): the largest square (d, d)
    parameter matrix servable when each chip budgets ``per_chip_bytes``
    for it.  Row-sharding over n chips stores d*d*dtype/n per chip, so
    d_max = floor(sqrt(per_chip_bytes * n / dtype)) — the ceiling grows
    with sqrt(n): 4 shards serve 2x the single-chip d, 16 shards 4x.
    Sharded results round DOWN to a multiple of n_shards (the row dim
    must divide evenly to shard)."""
    d = int((per_chip_bytes * n_shards / dtype_bytes) ** 0.5)
    if n_shards > 1:
        d -= d % n_shards
    return d

# Default coalescing contract of the PS methods (docs/batching.md):
# engages only on servers started with enable_batching=True; everywhere
# else the synthesized single-request adapter keeps the pre-batching
# behavior bit-for-bit.  Buckets cover every batch size ≤ 32, so the
# fused Forward kernel traces at most 6 times per row shape.
PS_BATCH_POLICY = BatchPolicy(
    max_batch_size=32,
    max_wait_us=1000,
    padding_buckets=(1, 2, 4, 8, 16, 32),
)


# Fused Forward kernel: Y = X @ W, one product per batch.  N separate
# matvecs each stream the full W from memory (bandwidth-bound), while
# the batched (rows, d) @ W streams W ONCE for the whole batch — the
# weight-reuse economics of inference serving.  FusedKernel shares the
# batching.fused trace counter, so padding buckets bound its traces the
# same way they bound the stack's.
_FORWARD_KERNEL = FusedKernel(
    promoted_matmul,
    label="ps.forward",
    batch_buckets=PS_BATCH_POLICY.padding_buckets,
)


class PsService(Service):
    """Parameter server: store/fetch tensors by key.

    Uses EchoRequest.message as the key channel and attachments as the
    tensor payload (device segments stay on the card over the ICI
    transport).

    All data methods are @batched_method.  Get/Put coalesce dispatch:
    one handler invocation and one store-lock acquisition serve the
    whole window.  Forward is the fused device op: N concurrent calls
    become ONE padded (bucket, d) @ W product that streams the
    parameter matrix once for the batch instead of once per request.

    ``device`` is where ``put_param`` places host arrays and where
    ``Get`` assembles a sharded value (default: the mesh's first chip's
    device with a mesh, else the card of chip 0; raises without a card
    unless given).

    Pod-scale mode (docs/sharded_ps.md): construct with ``mesh=`` and
    the store SHARDS eligible parameters across the mesh — a 2D matrix
    whose row dim divides the "chip" axis is placed row-sharded, so
    each chip holds d/n rows and the servable parameter size is bounded
    by per-chip memory times the shard count (``max_servable_dim``).
    Forward on a sharded key lowers the SAME padded batched product
    through ``batching/sharded.ShardedFusedKernel``: one sharded
    execution, cross-shard partials merged by ONE psum per batch.
    ``mesh=None`` (the default) is the single-chip service.
    """

    SERVICE_NAME = "PsService"

    def __init__(self, mesh=None, shard_axis: str = "chip", device=None):
        from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip

        if device is None and mesh is not None:
            device = mesh.devices.flat[0]
        self._device = device_for_chip(0, device)
        self._store: Dict[str, object] = {}
        self._lock = threading.Lock()
        self._sharded_keys: set = set()
        # per-key (bytes, allocs) HBM charge, mutated under self._lock
        self._hbm: Dict[str, tuple] = {}
        self._shard_kernel = None
        if mesh is not None and int(mesh.shape.get(shard_axis, 1)) > 1:
            from incubator_brpc_tpu_torch.batching.sharded import ShardedFusedKernel

            self._shard_kernel = ShardedFusedKernel(
                mesh, shard_axis, label=f"{self.SERVICE_NAME}.Forward"
            )

    @property
    def shard_kernel(self):
        """The sharded batch kernel (None on single-chip services) —
        its ``executions`` / ``collective_merges`` step log is how
        tests and the bench-smoke guard prove the sharded lowering."""
        return self._shard_kernel

    def _place(self, value):
        """(value as stored, whether it was sharded): row-sharded over
        the mesh when eligible, else a numpy array on the service's
        device, a tensor or ``bytes`` as is.  Runs outside the store
        lock."""
        if self._shard_kernel is not None:
            try:
                return self._shard_kernel.shard_param(value), True
            except (ValueError, AttributeError):
                pass  # ineligible shape: single-chip storage as-is
        if isinstance(value, np.ndarray):
            value = torch.from_numpy(np.ascontiguousarray(value)).to(self._device)
        return value, False

    def _store_rows(self, rows) -> None:
        """Store (key, value, sharded, charge) rows under one lock
        acquisition."""
        with self._lock:
            for key, val, sharded, charge in rows:
                _hbm_release(self._hbm.pop(key, _NO_CHARGE))
                self._store[key] = val
                if charge[0]:
                    self._hbm[key] = charge
                if sharded:
                    self._sharded_keys.add(key)
                else:
                    self._sharded_keys.discard(key)

    def put_param(self, key: str, value) -> bool:
        """Server-side store API (the bench and ops tooling seed through
        this; the Put RPC stores the same way).  Returns True when the
        value was sharded across the mesh."""
        value, sharded = self._place(value)
        # metadata-only charge: fine outside the lock
        self._store_rows([(key, value, sharded, _hbm_charge(value))])
        return sharded

    @batched_method(EchoRequest, EchoResponse, policy=PS_BATCH_POLICY)
    def Put(self, controllers, requests, responses, done):
        rows = []
        for controller, request, response in zip(controllers, requests, responses):
            att = controller.request_attachment
            try:
                arrays = att.device_arrays()
            except ValueError:
                arrays = None
            if arrays:
                # the fresh tensor the fabric delivered on this server
                # port's device: stored as is, or its rows placed on
                # the mesh's chips
                val = arrays[0] if len(arrays) == 1 else arrays
            else:
                val = att.to_bytes()
            val, sharded = self._place(val)
            rows.append((request.message, val, sharded, _hbm_charge(val)))
            response.message = request.message
        self._store_rows(rows)  # one acquisition serves the whole window
        done()

    @batched_method(EchoRequest, EchoResponse, policy=PS_BATCH_POLICY)
    def Get(self, controllers, requests, responses, done):
        # Get has no device compute to fuse — the stored tensor attaches
        # to the response as-is (zero device ops).  Batching still pays
        # off the per-request overheads: one handler invocation, one
        # store-lock acquisition, one dispatch per window instead of N.
        from incubator_brpc_tpu_torch import errors
        from incubator_brpc_tpu_torch.parallel.collectives import ShardedTensor

        with self._lock:
            vals = [self._store.get(r.message) for r in requests]
        for val, controller, request, response in zip(
            vals, controllers, requests, responses
        ):
            if val is None:
                controller.set_failed(
                    errors.EREQUEST, f"no such key: {request.message}"
                )
                continue
            if isinstance(val, ShardedTensor):
                # the logical W, assembled from its shards: never one
                # shard
                controller.response_attachment.append_device(
                    val.full(self._device)
                )
            elif isinstance(val, (bytes, bytearray)):
                controller.response_attachment.append(val)
            elif isinstance(val, list):
                for a in val:
                    controller.response_attachment.append_device(a)
            else:
                controller.response_attachment.append_device(val)
            response.message = request.message
        done()

    @rpc_method(EchoRequest, EchoResponse)
    def Keys(self, controller, request, response, done):
        """Enumerate this shard's live keys (newline-joined, sorted, in
        the response attachment).  Control-plane rate: plain
        (unbatched) by design."""
        with self._lock:
            keys = sorted(self._store)
        controller.response_attachment.append(
            "\n".join(keys).encode("utf-8")
        )
        response.message = str(len(keys))
        done()

    @rpc_method(EchoRequest, EchoResponse)
    def Delete(self, controller, request, response, done):
        """Remove a key (idempotent).  response.message is "1" when the
        key was live, "0" when it was already gone."""
        with self._lock:
            existed = request.message in self._store
            self._store.pop(request.message, None)
            self._sharded_keys.discard(request.message)
            _hbm_release(self._hbm.pop(request.message, _NO_CHARGE))
        response.message = "1" if existed else "0"
        done()

    def remesh(self, mesh, shard_axis: str = "chip") -> int:
        """Re-mesh the sharded store live (the server-side half of a
        scheme migration): re-target the sharded batch kernel at the
        new mesh and re-place every currently-sharded parameter under
        the new sharding (batching/sharded.ShardedFusedKernel.remesh).
        Returns the number of parameters re-placed.  ``mesh=None`` (or
        one chip) drops to single-chip mode: each sharded value is
        assembled on the service's device, and 0 is returned."""
        from incubator_brpc_tpu_torch.batching.sharded import ShardedFusedKernel

        with self._lock:
            sharded = {k: self._store[k] for k in self._sharded_keys}
        if mesh is None or int(mesh.shape.get(shard_axis, 1)) <= 1:
            kernel = None
            replaced = {k: v.full(self._device) for k, v in sharded.items()}
            still_sharded = set()
        else:
            if self._shard_kernel is not None:
                self._shard_kernel.remesh(mesh, shard_axis)
                kernel = self._shard_kernel
            else:
                kernel = ShardedFusedKernel(
                    mesh, shard_axis, label=f"{self.SERVICE_NAME}.Forward"
                )
            replaced = {}
            still_sharded = set()
            for key, val in sharded.items():
                # placement (device copies) runs outside the store lock
                try:
                    replaced[key] = kernel.shard_param(val)
                    still_sharded.add(key)
                except (ValueError, AttributeError):
                    # no longer shardable on the new mesh
                    replaced[key] = val.full(self._device)
        with self._lock:
            self._shard_kernel = kernel
            for key, val in replaced.items():
                if key in self._store:  # deleted while re-placing: skip
                    _hbm_release(self._hbm.pop(key, _NO_CHARGE))
                    self._store[key] = val
                    charge = _hbm_charge(val)
                    if charge[0]:
                        self._hbm[key] = charge
                    if key not in still_sharded:
                        self._sharded_keys.discard(key)
        return len(still_sharded)

    @batched_method(EchoRequest, EchoResponse, policy=PS_BATCH_POLICY)
    def Forward(self, controllers, requests, responses, done):
        """Apply a stored parameter matrix to a caller-supplied input:
        ``y = x @ W`` where ``W`` is the (d, d) tensor stored under
        ``request.message`` and ``x`` rides the request attachment as
        d float32s.  The response attachment carries ``y`` (d float32s).

        The fused device op: a batch of N concurrent Forwards becomes
        ONE padded (bucket, d) @ W product — one host-to-device copy of
        the stacked inputs, one product that streams W once instead of
        N times, one device-to-host pull of the n live rows (the batch's
        one sync).  Per-row validation failures (unknown key, wrong
        input size) fail only that row's controller; batch-mates still
        execute.
        """
        from incubator_brpc_tpu_torch import errors
        from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
        from incubator_brpc_tpu_torch.batching.batcher import current_batch
        from incubator_brpc_tpu_torch.observability.span import current_span

        with self._lock:
            params = {r.message: self._store.get(r.message) for r in requests}
            sharded = {k for k in params if k in self._sharded_keys}
            shard_kernel = self._shard_kernel
        # per-row parse + validate, grouped by parameter key so mixed
        # batches still fuse per key
        groups: Dict[str, list] = {}
        for i, (controller, request) in enumerate(zip(controllers, requests)):
            w = params.get(request.message)
            if w is None or len(getattr(w, "shape", ())) != 2:
                controller.set_failed(
                    errors.EREQUEST,
                    f"no parameter matrix under key: {request.message!r}",
                )
                continue
            d = int(w.shape[0])
            raw = controller.request_attachment.to_bytes()
            if len(raw) != d * 4:
                controller.set_failed(
                    errors.EREQUEST,
                    f"Forward input must be {d} float32s ({d * 4} bytes), "
                    f"got {len(raw)}",
                )
                continue
            groups.setdefault(request.message, []).append(
                (i, np.frombuffer(raw, np.float32))
            )
        ctx = current_batch()
        for key, rows in groups.items():
            w = params[key]
            n = len(rows)
            # bucket even without a batching context: direct multi-row
            # calls would otherwise specialize the kernel per exact n,
            # voiding the trace bound the buckets exist to enforce
            policy = ctx.policy if ctx is not None else PS_BATCH_POLICY
            pad_to = policy.bucket_for(n)
            # stack on host (zero-padded to the bucket), ship once
            X = np.zeros((max(pad_to, n), int(w.shape[0])), np.float32)
            for j, (_, x) in enumerate(rows):
                X[j] = x
            # sharded keys lower through the mesh kernel (one sharded
            # execution + one psum merge); everything else rides the
            # single-chip kernel unchanged
            on_mesh = key in sharded and shard_kernel is not None
            try:
                # device window: the pull below is the batch's one sync,
                # so the section (and the span's device phase) times the
                # upload, the product and the pull
                span = current_span()
                if span is not None:
                    span.stamp("device_start_us")
                with kernel_section("ps.forward"):
                    if on_mesh:
                        out = shard_kernel(w, X)
                    else:
                        out = _FORWARD_KERNEL(w, torch.from_numpy(X).to(w.device))
                    # pull ONLY the n live rows: the pad rows never cross
                    # the device boundary (the slice is a device view)
                    with allowed_transfer("ps.forward-pull"):
                        Y = (out[:n] if pad_to > n else out).cpu().numpy()
                if span is not None:
                    span.stamp("device_done_us")
            except Exception as e:  # noqa: BLE001 — a failed merge
                # (chaos collective.merge reset) or dispatch fails ONLY
                # this key-group's rows; other groups in the batch still
                # execute, and nothing is retried on one chip
                for i, _ in rows:
                    controllers[i].set_failed(
                        errors.EINTERNAL,
                        f"{'sharded ' if on_mesh else ''}forward failed for {key!r}: {e}",
                    )
                continue
            for j, (i, _) in enumerate(rows):
                # zero-copy attach: the row view keeps Y alive
                controllers[i].response_attachment.append_user_data(Y[j])
                responses[i].message = key
        done()


def ps_stub(channel) -> ServiceStub:
    return ServiceStub(channel, PsService)


# ---- client side: the shard-PER-SERVER fan-out contract ---------------------
#
# N PsService servers each own rows [k*d/N, (k+1)*d/N) of a parameter;
# Forward fans out once — each shard contracts the matching slice of x
# against its local rows and returns a PARTIAL y, merged client-side by
# one fused sum (ops/merge.merge_partial_sum).  Get/Put route to the
# owning shard only (client/combo.ShardRoutedChannel).


def ps_forward_prepare_leg(i, n, request, parent_ctrl, sub_ctrl):
    """Slice the caller's x by shard rows: leg i carries bytes
    [i*d/n*4, (i+1)*d/n*4) of the request attachment."""
    raw = parent_ctrl.request_attachment.to_bytes()
    if len(raw) % (4 * n):
        raise ValueError(
            f"Forward input of {len(raw)} bytes does not split into "
            f"{n} float32 row shards"
        )
    chunk = len(raw) // n
    sub_ctrl.request_attachment.append_user_data(raw[i * chunk:(i + 1) * chunk])
    return request


def ps_forward_merge(parent_ctrl, parent_resp, sub_ctrls, sub_resps):
    """Sum the per-shard partial y vectors (one fused op); a failed leg
    inside fail_limit simply contributes nothing — the degraded
    combo-channel contract."""
    from incubator_brpc_tpu_torch.analysis.device_witness import allowed_transfer
    from incubator_brpc_tpu_torch.ops.merge import merge_partial_sum

    parts = []
    key = ""
    for sc, sr in zip(sub_ctrls, sub_resps):
        if sc is None or sc.failed():
            continue
        parts.append(
            np.frombuffer(sc.response_attachment.to_bytes(), np.float32)
        )
        key = key or sr.message
    if not parts:
        raise ValueError("no successful shard legs to merge")
    with allowed_transfer("ps.client-merge"):
        y = merge_partial_sum(parts).cpu().numpy()
    parent_ctrl.response_attachment.append_user_data(y.tobytes())
    parent_resp.message = key


def sharded_ps_channel(sub_channels=None, endpoints=None, fail_limit=0,
                       timeout_ms=20000, seed=0, channel_options=None):
    """A ShardRoutedChannel wired for PsService: keyed Get/Put routing
    plus the Forward fan-out contract above.  Pass explicit
    ``sub_channels`` or ``endpoints`` (e.g. ``ici_endpoints(mesh)``);
    ``channel_options`` configures each endpoint's sub-channel (its
    ``timeout_ms`` bounds a routed Get/Put and each scatter Put)."""
    from incubator_brpc_tpu_torch.client.combo import (
        ParallelChannelOptions,
        ShardRoutedChannel,
    )

    opts = ParallelChannelOptions(fail_limit=fail_limit, timeout_ms=timeout_ms)
    if endpoints is not None:
        ch = ShardRoutedChannel.from_endpoints(
            endpoints, options=opts, channel_options=channel_options,
            seed=seed,
        )
    else:
        ch = ShardRoutedChannel(options=opts, seed=seed)
        ch.set_partitions(list(sub_channels or []))
    ch.set_fanout("Forward", ps_forward_prepare_leg, ps_forward_merge)
    return ch


def _shard_device(part) -> torch.device:
    """Where shard ``part``'s rows are made: the device of its server's
    fabric port when that server runs in this process, else the
    channel's ``ici_device``, else the card of its chip (raises with
    neither a card nor a device)."""
    from incubator_brpc_tpu_torch.parallel.ici import get_fabric
    from incubator_brpc_tpu_torch.parallel.mesh import device_for_chip

    ep = getattr(part, "_endpoint", None)
    coords = ep.coords if ep is not None and ep.is_ici() else None
    port = get_fabric().port(coords) if coords is not None else None
    if port is not None and port.device is not None:
        return torch.device(port.device)
    options = getattr(part, "options", None)
    return device_for_chip(coords[1] if coords else 0,
                           getattr(options, "ici_device", None))


def scatter_param(shard_channel, key: str, w) -> None:
    """Row-scatter a parameter across the shard servers: shard k gets
    rows [k*d/n, (k+1)*d/n) as a device payload under the same key.
    After this, a fan-out Forward against `key` serves the full matrix.

    A numpy ``w`` is sliced and made a tensor on each shard's device
    (``_shard_device``); a tensor ``w`` gives each shard a contiguous
    row slice on its own device.  A failed Put fails the scatter."""
    from incubator_brpc_tpu_torch.client.controller import Controller

    parts = shard_channel.partitions()
    n = len(parts)
    d = int(w.shape[0])
    if n == 0 or d % n:
        raise ValueError(f"{d} rows do not scatter over {n} shards")
    rows = d // n
    for i, part in enumerate(parts):
        lo, hi = i * rows, (i + 1) * rows
        if isinstance(w, torch.Tensor):
            block = w[lo:hi].contiguous()
        else:
            block = torch.from_numpy(np.ascontiguousarray(w[lo:hi])).to(
                _shard_device(part)
            )
        stub = ps_stub(part)
        c = Controller()
        c.request_attachment.append_device(block)
        stub.Put(c, EchoRequest(message=key))
        if c.failed():
            raise RuntimeError(
                f"scatter_param: shard {i} Put failed: {c.error_text()}"
            )


# ---- device side: the flagship sharded training step -----------------------
#
# Shardings (scaling-book recipe): W1 column-sharded over "chip", W2
# row-sharded over "chip" (the matmul partials psum over "chip"), the
# batch x row-split over "slice" (data parallel: the gradients reduce
# over "slice").
def train_specs():
    """{"w1": spec, "w2": spec, "x": spec} of ``make_training_step``."""
    from incubator_brpc_tpu_torch.parallel.collectives import P

    return {"w1": P(None, "chip"), "w2": P("chip", None), "x": P("slice", None)}


def _training_step(params, x, lr: float):
    """One SGD step of ``mean((relu(x @ w1) @ w2) ** 2)`` over the mesh
    of ``x``.  Each (slice, chip) computes its partial from its own
    shards; the psum over "chip" is ``psum_in_order`` (autograd
    differentiates it); the replicas of a chip's weight shard on the
    other slices' devices are differentiable copies of one leaf per
    chip, so autograd's own sum into each leaf is the gradient
    reduction over "slice".  Returns (new_params, loss), the new shards
    re-placed on every chip and the loss on the first chip's device."""
    from incubator_brpc_tpu_torch.parallel.collectives import ShardedTensor, psum_in_order

    mesh = x.mesh
    n_slices, n_chips = mesh.devices.shape
    leaves = {
        name: [params[name].shard_at((0, c)).detach().requires_grad_()
               for c in range(n_chips)]
        for name in ("w1", "w2")
    }
    total = None
    for s in range(n_slices):
        parts = []
        for c in range(n_chips):
            dev = mesh.devices[s, c]
            h = torch.relu(x.shard_at((s, c)) @ leaves["w1"][c].to(dev))
            parts.append(h @ leaves["w2"][c].to(dev))
        y = psum_in_order(parts, owned=True)  # the psum over "chip"
        sq = (y * y).sum()
        total = sq if total is None else total + sq.to(total.device)
    loss = total / (x.shape[0] * params["w2"].shape[1])
    loss.backward()
    new_params = {}
    with torch.no_grad():
        for name, ws in leaves.items():
            new = [w - lr * w.grad for w in ws]
            # re-place: each chip's new shard, copied to the devices of
            # the other slices' replicas
            shards = [new[c].to(mesh.devices[s, c])
                      for s in range(n_slices) for c in range(n_chips)]
            new_params[name] = ShardedTensor(mesh, params[name].spec, shards,
                                             params[name].shape)
    return new_params, loss.detach()


def make_training_step(mesh, dim: int = 256, batch: int = 32, lr: float = 0.01):
    """Build (step_fn, params, batch) over `mesh`, the JAX package's
    dp x tp step: ``step_fn(params, x) -> (new_params, loss)``.

    Shardings (``train_specs()``):
      - W1: P(None, "chip")   tensor-parallel column shard
      - W2: P("chip", None)   tensor-parallel row shard (the matmul
                               partials psum over "chip")
      - batch x: P("slice", None)  data-parallel; the gradients reduce
                               over "slice"

    The initial values come from ``torch.Generator`` seeded 0 (they
    cannot equal ``jax.random``'s); ``convert.training_state_from_reference``
    carries the JAX step's state across instead."""
    from incubator_brpc_tpu_torch.parallel.collectives import shard_tensor

    specs = train_specs()
    g = torch.Generator().manual_seed(0)
    w1 = torch.randn((dim, dim), generator=g) / dim ** 0.5
    w2 = torch.randn((dim, dim), generator=g) / dim ** 0.5
    x = torch.randn((batch, dim), generator=g)
    params = {
        "w1": shard_tensor(w1, mesh, specs["w1"]),
        "w2": shard_tensor(w2, mesh, specs["w2"]),
    }

    def step(params, x):
        return _training_step(params, x, lr)

    return step, params, shard_tensor(x, mesh, specs["x"])
