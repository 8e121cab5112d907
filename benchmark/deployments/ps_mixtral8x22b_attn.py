"""``ps_mixtral8x22b_attn``: a ``PsService`` shard on a
``Server(enable_batching=True)`` over ``ici://`` on one card, holding the
square attention projections of every layer of the configuration's model
and serving ``Forward`` (y = x @ W) through the server's micro-batcher
under the service's batch policy.

Set-up makes every key's W ((d, d) float32, scaled by 1/sqrt(d)) on the
card from the seed, eight keys a call, and stores each with one ``Put``
over ``ici://``: the program keeps the copy the fabric delivered.  The
benchmark keeps its own copy of the one key the traffic asks for (drawn
from the seed), for the reference, and a pool of input rows, which go
out as host bytes, as the service takes them.  TF32 stays off, as the
configuration states.

What a call keeps for the check: its row's number in the pool and the
reply's bytes.
"""

from __future__ import annotations

import random

import torch

from benchmark.harness.device import sync

CHIP = 62
KEYS_A_CALL = 8  # keys made from the seed in one call on the card


def set_tf32(on: bool) -> None:
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def keys_of(config: dict):
    """The shard's keys, layer by layer: ``layers.<l>.<projection>``."""
    return [f"layers.{layer}.{proj}" for layer in range(int(config["num_hidden_layers"]))
            for proj in config["projections"]]


class Deployment:
    def __init__(self, config: dict, mix: dict, device, seed: int, ranges):
        from incubator_brpc_tpu_torch.client.channel import Channel, ChannelOptions
        from incubator_brpc_tpu_torch.models.parameter_server import PsService, ps_stub
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest
        from incubator_brpc_tpu_torch.server.server import Server, ServerOptions

        self.device = device
        self.ranges = ranges
        self.d = d = int(config["hidden_size"])
        if int(config["num_attention_heads"]) * int(config["head_dim"]) != d:
            raise ValueError("the configuration's projections are not square")
        self.timeout_ms = int(config["timeout_ms"])
        set_tf32(bool(config["tf32"]))
        self.server = Server(ServerOptions(enable_batching=bool(config["enable_batching"])))
        self.service = PsService(device=device)
        self.server.add_service(self.service)
        if self.server.start_ici(0, CHIP, device=device) != 0:
            raise RuntimeError("start_ici failed")
        self.batcher = self.server.batcher("PsService.Forward")
        self._check_policy(config["batch_policy"])
        self.channels = int(mix.get("channels", 1))
        self._chans = []
        for _ in range(self.channels):
            ch = Channel(ChannelOptions(timeout_ms=self.timeout_ms, ici_device=device))
            if ch.init(f"ici://slice0/chip{CHIP}") != 0:
                raise RuntimeError("channel init failed")
            self._chans.append(ch)
        self._stubs = [ps_stub(ch) for ch in self._chans]
        self._keys = keys = keys_of(config)
        self.key = keys[random.Random(seed).randrange(len(keys))]
        self._req = EchoRequest(message=self.key)
        gen = torch.Generator(device=device).manual_seed(seed)
        self.W = self._put_all(ps_stub(self._chans[0]), keys, gen)
        self.rows = torch.randn((int(mix["pool"]), d), generator=gen, device=device,
                                dtype=torch.float32)
        host = self.rows.cpu().numpy()
        self._x = [r.tobytes() for r in host]
        buckets = [b for b in config["batch_policy"]["padding_buckets"]
                   if b <= self._bucket(int(mix["inflight"]), config["batch_policy"])]
        self._warm_products(buckets)

    def _check_policy(self, want: dict) -> None:
        """The program must serve the batch policy the configuration states."""
        if self.batcher is None:
            raise RuntimeError("PsService.Forward is not batched on this server")
        p = self.batcher.policy
        have = {"max_batch_size": p.max_batch_size, "max_wait_us": p.max_wait_us,
                "padding_buckets": list(p.padding_buckets)}
        if have != want:
            raise RuntimeError(f"the server's Forward policy {have} is not the configuration's {want}")

    @staticmethod
    def _bucket(rows: int, policy: dict) -> int:
        n = min(rows, policy["max_batch_size"])
        return min(b for b in policy["padding_buckets"] if b >= n)

    def _put_all(self, stub, keys, gen) -> torch.Tensor:
        """Store every key's W with one ``Put`` each; the benchmark's own
        copy of the served key's W, for the reference."""
        from incubator_brpc_tpu_torch.client.controller import Controller
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

        d, served = self.d, None
        for at in range(0, len(keys), KEYS_A_CALL):
            part = keys[at:at + KEYS_A_CALL]
            ws = torch.randn((len(part), d, d), generator=gen, device=self.device,
                             dtype=torch.float32)
            ws.mul_(d ** -0.5)
            for key, w in zip(part, ws):
                c = Controller()
                c.timeout_ms = self.timeout_ms
                c.request_attachment.append_device(w)
                stub.Put(c, EchoRequest(message=key))
                if c.failed():
                    raise RuntimeError(f"Put of {key} failed: {c.error_text()}")
                if key == self.key:
                    served = w.clone()
            sync(self.device)
            del ws
        return served

    def _warm_products(self, buckets) -> None:
        """Initialise the card's matrix library for each (bucket, d) @ (d, d)
        product the traffic can reach, as the server's batches pad to them."""
        for b in buckets:
            torch.zeros((b, self.d), device=self.device) @ self.W
        sync(self.device)

    # ---- calls ---------------------------------------------------------
    def _controller(self, idx: int):
        from incubator_brpc_tpu_torch.client.controller import Controller

        c = Controller()
        c.timeout_ms = self.timeout_ms
        c.request_attachment.append_user_data(self._x[idx])
        return c

    @staticmethod
    def _reply(c, idx: int):
        if c.failed():
            return False, c.error_text()
        return True, (idx, c.response_attachment.to_bytes())

    def call(self, chan: int, k: int, done) -> None:
        idx = k % len(self._x)
        c = self._controller(idx)

        def on_done():
            with self.ranges("client.done"):
                ok, record = self._reply(c, idx)
            done(ok, record)

        self._stubs[chan].Forward(c, self._req, done=on_done)

    def call_sync(self, k: int):
        idx = k % len(self._x)
        c = self._controller(idx)
        self._stubs[0].Forward(c, self._req)
        return self._reply(c, idx)

    def sync(self) -> None:
        sync(self.device)

    def counters(self) -> dict:
        b = self.batcher
        return {"forward_rows": b.rows, "forward_batches": b.batches}

    def warm(self, gen, mix: dict, ranges) -> None:
        gen.run(self, mix, calls=int(mix["warmup_calls"]), ranges=ranges)

    # ---- after the window -----------------------------------------------
    def close_program(self) -> None:
        """Delete every key through the service, then stop the server: the
        stopped server stays reachable from the program's socket pool and
        its ``ici://`` port, and would hold the shard's 16.9 GB with it."""
        from incubator_brpc_tpu_torch.client.controller import Controller
        from incubator_brpc_tpu_torch.protos.echo_pb2 import EchoRequest

        for key in self._keys if self._stubs else []:
            c = Controller()
            c.timeout_ms = self.timeout_ms
            self._stubs[0].Delete(c, EchoRequest(message=key))
        self._keys = []
        for ch in self._chans:
            ch.close()
        self._chans, self._stubs = [], []
        if self.server is not None:
            self.server.stop()
            self.server = None
            self.service = None
            self.batcher = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, window, ref) -> dict:
        """The numbers compared, each judged against the reference."""
        records = [c.record for c in window.completed]
        good = [(i, y) for i, y in records if len(y) == self.d * 4]
        return {
            "y_malformed": len(records) - len(good),
            "y_gap": ref.forward_gap(good, self.rows, self.W),
        }

    def control_check(self, window, ref) -> dict:
        """The check with the reference in the program's place one
        precision lower: TF32 products (``ref.control_forward``) of the
        same calls' rows.  The program's own TF32 switch is no control at
        one row a batch: the matrix library's GEMV ignores it."""
        y = ref.control_forward(self.rows, self.W).cpu().numpy()
        records = [c.record for c in window.completed]
        return {
            "y_malformed": 0,
            "y_gap": ref.forward_gap([(i, y[i].tobytes()) for i, _ in records], self.rows, self.W),
        }

    def close(self) -> None:
        self.close_program()
        self.W = self.rows = None
        self._x = []
