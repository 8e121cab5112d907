"""``ici_echo``: an ``EchoService`` on a ``Server(usercode_in_dispatcher=True)``
over ``ici://`` on one card, its clients' channels on the same card.

Both hops of every echo copy and checksum the payload (the fabric's
``fused`` chunk mode, ``zero_copy`` off, as the configuration states).
The payloads are made on the card from the seed, in one call; a chained
mix (``"chain": true``) sends the first of them and then each reply, any
other mix sends the pool's payloads by the call's number.

What a call keeps for the check: whether the reply's storage is the
request's and the checksum that travelled with the reply (a device
scalar).  The replies themselves are kept only as a sample of ``keep``
replies drawn from the seed over the window's calls (a reservoir: a
reply that drops out of it is freed, as a client frees its replies),
and, in a chain, the last reply, which every hop's bytes pass through.
"""

from __future__ import annotations

import random
import threading

import torch

from benchmark.harness.device import sync

CHIP = 63  # the server's ici:// coordinates: slice 0, this chip number
_DTYPES = {"float32": torch.float32}


def zero_copy(dep) -> None:
    """A fault through the program's own path: the fabric's zero-copy
    mode, whose reply is the request's buffer and carries no checksum."""
    dep.fabric.zero_copy = True


FAULTS = {"zero_copy": zero_copy}


class Deployment:
    def __init__(self, config: dict, mix: dict, device, seed: int, ranges):
        from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu_torch.models.echo import EchoService, echo_stub
        from incubator_brpc_tpu_torch.parallel.ici import get_fabric
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
        from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

        self.device = device
        self.ranges = ranges
        self.timeout_ms = int(config["timeout_ms"])
        self.fabric = get_fabric()
        self.fabric.chunk_mode = config["chunk_mode"]
        self.fabric.zero_copy = bool(config["zero_copy"])
        self.server = Server(ServerOptions(
            usercode_in_dispatcher=bool(config["usercode_in_dispatcher"])))
        self.server.add_service(EchoService())
        if self.server.start_ici(0, CHIP, device=device) != 0:
            raise RuntimeError("start_ici failed")
        self.channels = int(mix.get("channels", 1))
        self._chans = []
        for _ in range(self.channels):
            ch = Channel(ChannelOptions(timeout_ms=self.timeout_ms, ici_device=device))
            if ch.init(f"ici://slice0/chip{CHIP}") != 0:
                raise RuntimeError("channel init failed")
            self._chans.append(ch)
        self._stubs = [echo_stub(ch) for ch in self._chans]
        self._req = EchoRequest(message="bench")
        payload = mix["payload"]
        shape = tuple(payload["shape"])
        n = int(mix.get("pool", 1))
        gen = torch.Generator(device=device).manual_seed(seed)
        self.pool = torch.randn((n, *shape), generator=gen, device=device,
                                dtype=_DTYPES[payload["dtype"]])
        self.chain = bool(mix.get("chain", False))
        self.last_reply = None
        self._keep = int(mix["keep"])
        self._seed = seed
        self._lock = threading.Lock()
        self._begin_sample()

    def _begin_sample(self) -> None:
        self._rng = random.Random(self._seed)
        self._seen = 0
        self.kept = {}  # reservoir slot -> (pool index, reply)

    def _sample(self, idx: int, y) -> None:
        """Algorithm R: after n replies each is kept with chance keep / n."""
        with self._lock:
            n, self._seen = self._seen, self._seen + 1
            slot = n if n < self._keep else self._rng.randrange(n + 1)
            if slot < self._keep:
                self.kept[slot] = (idx, y)

    # ---- calls ---------------------------------------------------------
    def _controller(self, x):
        from incubator_brpc_tpu_torch.client.controller import Controller

        c = Controller()
        c.timeout_ms = self.timeout_ms
        c.request_attachment.append_device(x)
        return c

    def _reply(self, c, x, idx):
        """(ok, reply tensor, record) of a finished controller."""
        if c.failed():
            return False, None, c.error_text()
        segs = c.response_attachment.device_segments()
        if len(segs) != 1 or segs[0].whole_array() is None:
            return False, None, f"reply holds {len(segs)} device segments, not one whole"
        seg = segs[0]
        y = seg.array
        aliased = y.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()
        self._sample(idx, y)
        return True, y, (idx, aliased, seg.csum)

    def call(self, chan: int, k: int, done) -> None:
        idx = k % self.pool.shape[0]
        x = self.pool[idx]
        c = self._controller(x)

        def on_done():
            with self.ranges("client.done"):
                ok, _, record = self._reply(c, x, idx)
            done(ok, record)

        self._stubs[chan].Echo(c, self._req, done=on_done)

    def call_sync(self, k: int):
        """One call on the first channel; a chain sends the last reply,
        and starts again from the pool's first payload after a failure."""
        if self.chain:
            idx, x = 0, self.last_reply if self.last_reply is not None else self.pool[0]
        else:
            idx = k % self.pool.shape[0]
            x = self.pool[idx]
        c = self._controller(x)
        self._stubs[0].Echo(c, self._req)
        ok, y, record = self._reply(c, x, idx)
        if self.chain:
            self.last_reply = y
        return ok, record

    def sync(self) -> None:
        sync(self.device)

    def counters(self) -> dict:
        return {}

    def warm(self, gen, mix: dict, ranges) -> None:
        gen.run(self, mix, calls=int(mix["warmup_calls"]), ranges=ranges)
        self._begin_sample()  # the sample is of the window's replies

    # ---- after the window -----------------------------------------------
    def close_program(self) -> None:
        for ch in self._chans:
            ch.close()
        self._chans, self._stubs = [], []
        if self.server is not None:
            self.server.stop()
            self.server = None

    def check(self, window, ref) -> dict:
        """The numbers compared, each judged against the reference."""
        records = [c.record for c in window.completed]
        return {
            "reply_bytes_wrong": ref.replies_wrong(self._kept_replies(), self.pool),
            "reply_aliased": sum(1 for _, a, _ in records if a),
            "csum_missing": sum(1 for _, _, s in records if s is None),
            "csum_gap": ref.checksum_gap(
                [(i, s) for i, _, s in records if s is not None],
                ref.checksum(self.pool), ref.magnitude(self.pool)),
        }

    def _kept_replies(self):
        """(pool index, reply) of the sample, and a chain's last reply:
        every earlier hop's bytes pass through it."""
        kept = [self.kept[slot] for slot in sorted(self.kept)]
        if self.chain and self.last_reply is not None:
            kept.append((0, self.last_reply))
        return kept

    def control_check(self, window, ref) -> dict:
        """The check with the reference in the program's place, one
        precision lower: each reply and its checksum as
        ``ref.control_reply`` gives them, for the same calls."""
        ctrl = {}

        def of(i):
            if i not in ctrl:
                ctrl[i] = ref.control_reply(self.pool[i])
            return ctrl[i]

        records = [c.record for c in window.completed]
        return {
            "reply_bytes_wrong": ref.replies_wrong(
                [(i, of(i)[0]) for i, _ in self._kept_replies()], self.pool),
            "reply_aliased": 0,
            "csum_missing": 0,
            "csum_gap": ref.checksum_gap([(i, of(i)[1]) for i, _, _ in records],
                                         ref.checksum(self.pool), ref.magnitude(self.pool)),
        }

    def close(self) -> None:
        self.close_program()
        self.last_reply = None
        self.kept = {}
        self.pool = None
