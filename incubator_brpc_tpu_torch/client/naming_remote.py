"""Remote naming services — DNS, remotefile, consul, discovery, nacos.

Analogs of the reference's network-backed naming services
(global.cpp:128-139): domain_naming_service.cpp (http://host DNS
round-robin), remote_file_naming_service.cpp (server list fetched over
HTTP), consul_naming_service.cpp (/v1/health/service),
discovery_naming_service.cpp (Bilibili discovery /discovery/fetch), and
nacos_naming_service.cpp (/nacos/v1/ns/instance/list). All are
PeriodicNamingService subclasses: poll, diff, push.

Everything uses stdlib urllib against the address embedded in the
naming URL, so tests can point them at an in-process HTTP server.
"""

from __future__ import annotations

import json
import socket as _pysocket
import urllib.request
from typing import List
from urllib.parse import parse_qs, urlsplit

from incubator_brpc_tpu_torch.client.naming_service import (
    PeriodicNamingService,
    ServerNode,
    register_naming_service,
)
from incubator_brpc_tpu_torch.utils.endpoint import EndPoint

_HTTP_TIMEOUT_S = 3.0


def _http_get(url: str) -> bytes:
    with urllib.request.urlopen(url, timeout=_HTTP_TIMEOUT_S) as resp:
        return resp.read()


class DomainNamingService(PeriodicNamingService):
    """http://host[:port] — DNS A/AAAA records, one node per address
    (reference domain_naming_service.cpp + http default port)."""

    name = "http"
    default_port = 80
    interval_s = 5.0

    def get_servers(self, path: str) -> List[ServerNode]:
        hostport = path.split("/", 1)[0]
        host, _, port_s = hostport.partition(":")
        port = int(port_s) if port_s else self.default_port
        infos = _pysocket.getaddrinfo(
            host, port, _pysocket.AF_UNSPEC, _pysocket.SOCK_STREAM
        )
        seen = set()
        nodes = []
        for _f, _t, _p, _cn, sockaddr in infos:
            addr = sockaddr[0]
            if addr in seen:
                continue
            seen.add(addr)
            nodes.append(ServerNode(EndPoint.tcp(addr, port)))
        return sorted(nodes, key=lambda n: str(n.endpoint))


class HttpsDomainNamingService(DomainNamingService):
    name = "https"
    default_port = 443


class RemoteFileNamingService(PeriodicNamingService):
    """remotefile://host:port/path — the server list itself is fetched
    over HTTP; body format matches file:// (one 'host:port [w] [tag]'
    per line). Reference remote_file_naming_service.cpp."""

    name = "remotefile"
    interval_s = 5.0

    def get_servers(self, path: str) -> List[ServerNode]:
        from incubator_brpc_tpu_torch.client.naming_service import _parse_node_line

        body = _http_get(f"http://{path}").decode()
        nodes = []
        for line in body.splitlines():
            node = _parse_node_line(line)
            if node:
                nodes.append(node)
        return nodes


class ConsulNamingService(PeriodicNamingService):
    """consul://host:port/service-name — healthy instances from the
    consul HTTP API (reference consul_naming_service.cpp long-polls
    /v1/health/service; this polls the same endpoint periodically)."""

    name = "consul"
    interval_s = 2.0

    def get_servers(self, path: str) -> List[ServerNode]:
        hostport, _, service = path.partition("/")
        data = json.loads(
            _http_get(
                f"http://{hostport}/v1/health/service/{service}?passing=true"
            )
        )
        nodes = []
        for entry in data:
            svc = entry.get("Service", {})
            addr = svc.get("Address") or entry.get("Node", {}).get("Address")
            port = svc.get("Port")
            if not addr or not port:
                continue
            weight = (svc.get("Weights") or {}).get("Passing", 1)
            tags = svc.get("Tags") or []
            nodes.append(
                ServerNode(
                    EndPoint.tcp(addr, int(port)),
                    int(weight) or 1,
                    tags[0] if tags else "",
                )
            )
        return nodes


class DiscoveryNamingService(PeriodicNamingService):
    """discovery://host:port/appid — Bilibili discovery
    (reference discovery_naming_service.cpp /discovery/fetch):
    data.<appid>.instances[].addrs like 'grpc://1.2.3.4:9000'."""

    name = "discovery"
    interval_s = 2.0

    def get_servers(self, path: str) -> List[ServerNode]:
        hostport, _, appid = path.partition("/")
        raw = json.loads(
            _http_get(
                f"http://{hostport}/discovery/fetch?appid={appid}"
                "&env=prod&status=1"
            )
        )
        data = raw.get("data", {})
        # data may be keyed by appid or be the instance obj directly
        inst_holder = data.get(appid, data) if isinstance(data, dict) else {}
        nodes = []
        for inst in inst_holder.get("instances", []):
            for addr in inst.get("addrs", []):
                _, _, hp = addr.partition("://")
                host, _, port_s = hp.partition(":")
                if host and port_s:
                    nodes.append(ServerNode(EndPoint.tcp(host, int(port_s))))
        return nodes


class NacosNamingService(PeriodicNamingService):
    """nacos://host:port/serviceName[?namespaceId=..&groupName=..] —
    healthy instances from /nacos/v1/ns/instance/list (reference
    nacos_naming_service.cpp)."""

    name = "nacos"
    interval_s = 2.0

    def get_servers(self, path: str) -> List[ServerNode]:
        hostport, _, rest = path.partition("/")
        service, _, query = rest.partition("?")
        params = {k: v[0] for k, v in parse_qs(query).items()}
        url = (
            f"http://{hostport}/nacos/v1/ns/instance/list"
            f"?serviceName={service}&healthyOnly=true"
        )
        for k in ("namespaceId", "groupName"):
            if k in params:
                url += f"&{k}={params[k]}"
        data = json.loads(_http_get(url))
        nodes = []
        for host in data.get("hosts", []):
            if not host.get("enabled", True) or not host.get("healthy", True):
                continue
            nodes.append(
                ServerNode(
                    EndPoint.tcp(host["ip"], int(host["port"])),
                    max(1, int(float(host.get("weight", 1)))),
                )
            )
        return nodes


def register_remote_naming_services():
    register_naming_service(DomainNamingService())
    register_naming_service(HttpsDomainNamingService())
    register_naming_service(RemoteFileNamingService())
    register_naming_service(ConsulNamingService())
    register_naming_service(DiscoveryNamingService())
    register_naming_service(NacosNamingService())


register_remote_naming_services()
