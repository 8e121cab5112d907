"""Naming services — cluster membership discovery.

Analog of reference NamingService (naming_service.h:30-70): an NS
watches a source and *pushes* server-list updates to its watcher
(NamingServiceActions::ResetServers); polling impls subclass
PeriodicNamingService; NamingServiceThread dedups watchers per URL
(details/naming_service_thread.{h,cpp}).

Built-ins (reference set minus Baidu-internal ones, global.cpp:128-139):
  list://host:port[ w],host:port   static list with optional weights
  file://path                      file with one "host:port [w]" per
                                   line, watched for changes
  tpu://                           the TPU topology: every ici://
                                   port registered on the fabric, plus
                                   mesh devices — the "naming-service
                                   layer resolves TPU slice
                                   coordinates" north-star piece
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from incubator_brpc_tpu_torch.utils.endpoint import EndPoint, str2endpoint
from incubator_brpc_tpu_torch.utils.logging import log_error


@dataclass(frozen=True)
class ServerNode:
    """Analog of brpc::ServerNode (naming_service.h)."""

    endpoint: EndPoint
    weight: int = 1
    tag: str = ""  # PartitionChannel reads "N/M" partition tags from here


class NamingServiceWatcher:
    """Actions interface (NamingServiceActions): receives full resets."""

    def on_servers_changed(self, nodes: List[ServerNode]) -> None:
        raise NotImplementedError


class NamingService:
    name = ""

    def run(self, url: str, watcher: NamingServiceWatcher, stop_event) -> None:
        raise NotImplementedError


def _parse_node_line(line: str) -> Optional[ServerNode]:
    line = line.split("#", 1)[0].strip()
    if not line:
        return None
    parts = line.split()
    ep = str2endpoint(parts[0])
    weight = int(parts[1]) if len(parts) > 1 else 1
    tag = parts[2] if len(parts) > 2 else ""
    return ServerNode(ep, weight, tag)


class PeriodicNamingService(NamingService):
    """Base for polling services (reference PeriodicNamingService)."""

    interval_s = 1.0

    def get_servers(self, path: str) -> List[ServerNode]:
        raise NotImplementedError

    def run(self, url: str, watcher: NamingServiceWatcher, stop_event) -> None:
        path = url.split("://", 1)[1] if "://" in url else url
        last: Optional[List[ServerNode]] = None
        while not stop_event.is_set():
            try:
                nodes = self.get_servers(path)
                if nodes != last:
                    last = nodes
                    watcher.on_servers_changed(nodes)
            except Exception as e:  # noqa: BLE001
                log_error("naming service %s failed: %r", url, e)
            stop_event.wait(self.interval_s)


class ListNamingService(NamingService):
    """list://addr[ w][;tag],addr — static, resolved once."""

    name = "list"

    def run(self, url, watcher, stop_event):
        body = url.split("://", 1)[1]
        nodes = []
        for item in body.split(","):
            node = _parse_node_line(item.replace(";", " "))
            if node:
                nodes.append(node)
        watcher.on_servers_changed(nodes)
        stop_event.wait()  # static: nothing more to do


class FileNamingService(PeriodicNamingService):
    """file://path — one node per line, re-read when it changes
    (the reference test suite's cluster simulator, SURVEY.md §4)."""

    name = "file"

    def get_servers(self, path: str) -> List[ServerNode]:
        nodes = []
        with open(path) as f:
            for line in f:
                node = _parse_node_line(line)
                if node:
                    nodes.append(node)
        return nodes


class TpuTopologyNamingService(PeriodicNamingService):
    """tpu:// — resolve TPU slice coordinates: every server port
    registered on the ICI fabric (tpu://fabric, the default), or the
    mesh devices (tpu://mesh)."""

    name = "tpu"
    interval_s = 0.5

    def get_servers(self, path: str) -> List[ServerNode]:
        if path in ("", "fabric"):
            from incubator_brpc_tpu_torch.parallel.ici import get_fabric

            return [
                ServerNode(EndPoint.ici(*coords))
                for coords in get_fabric().server_coords()
            ]
        if path == "mesh":
            from incubator_brpc_tpu_torch.parallel.mesh import default_mesh, ici_endpoints

            return [ServerNode(ep) for ep in ici_endpoints(default_mesh())]
        raise ValueError(f"unknown tpu:// path {path!r}")


_registry: Dict[str, NamingService] = {}


def register_naming_service(ns: NamingService):
    _registry[ns.name] = ns


def find_naming_service(url: str) -> Optional[NamingService]:
    scheme = url.split("://", 1)[0] if "://" in url else ""
    return _registry.get(scheme)


register_naming_service(ListNamingService())
register_naming_service(FileNamingService())
register_naming_service(TpuTopologyNamingService())


class NamingServiceThread:
    """One background thread per (url); multiplexes watchers
    (reference details/naming_service_thread.{h,cpp})."""

    _threads: Dict[str, "NamingServiceThread"] = {}
    _threads_lock = threading.Lock()

    def __init__(self, url: str, ns: NamingService):
        self.url = url
        self._ns = ns
        self._watchers: List[NamingServiceWatcher] = []
        self._last_nodes: Optional[List[ServerNode]] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name=f"tpubrpc-ns-{ns.name}"
        )
        self._thread.start()

    class _Fan(NamingServiceWatcher):
        def __init__(self, owner):
            self.owner = owner

        def on_servers_changed(self, nodes):
            with self.owner._lock:
                self.owner._last_nodes = list(nodes)
                watchers = list(self.owner._watchers)
            for w in watchers:
                try:
                    w.on_servers_changed(nodes)
                except Exception as e:  # noqa: BLE001
                    log_error("ns watcher raised: %r", e)

    def _run(self):
        try:
            self._ns.run(self.url, NamingServiceThread._Fan(self), self._stop)
        except Exception as e:  # noqa: BLE001 — a bad URL must not kill the
            # cached thread silently; deliver an empty list so watchers see
            # ENOSERVICE rather than hanging on stale state
            log_error("naming service %s died: %r", self.url, e)
            NamingServiceThread._Fan(self).on_servers_changed([])

    def add_watcher(self, watcher: NamingServiceWatcher):
        with self._lock:
            self._watchers.append(watcher)
            nodes = self._last_nodes
        if nodes is not None:
            watcher.on_servers_changed(nodes)

    def remove_watcher(self, watcher: NamingServiceWatcher):
        with self._lock:
            try:
                self._watchers.remove(watcher)
            except ValueError:
                pass

    @classmethod
    def get(cls, url: str) -> Optional["NamingServiceThread"]:
        ns = find_naming_service(url)
        if ns is None:
            return None
        with cls._threads_lock:
            t = cls._threads.get(url)
            if t is None:
                t = cls(url, ns)
                cls._threads[url] = t
            return t
