"""Client→server node RPCs over the wire.

Reference: the client dials servers over yamux-multiplexed msgpack RPC
(``client/client.go:1997`` watchAllocations → ``Node.GetClientAllocs``
``nomad/node_endpoint.go:915``; ``registerAndHeartbeat`` :1550 →
Node.Register/UpdateStatus; batched ``Node.UpdateAlloc`` :1054).

This build's wire is HTTP+JSON (serde full-fidelity encoding, NOT the
human-facing ``/v1`` JSON) on the server agent's existing listener, under
``/v1/internal/``.  ``HTTPServerRPC`` implements the exact five-method
surface the in-process ``Server`` object exposes to ``Client``, so a
client agent runs unchanged against either — the same seam the reference
has between ``client.RPC`` and in-process test servers.

Blocking queries carry their wait budget in the request and hold the HTTP
response open server-side (the memdb WatchSet discipline over the wire).

A copy of the reference package's ``api/rpc.py``, its ``rpc.call`` chaos
seam (``drop``, ``error``, ``dup``) and trace event included.
"""

from __future__ import annotations

import json
import re
import urllib.error
import urllib.request
from typing import List, Tuple

from .. import trace
from ..chaos import inject
from ..retry import RetryBudgetExceeded, RetryPolicy, retry_call
from ..structs import serde
from ..structs.types import Allocation, Node


class RPCError(Exception):
    pass


class HTTPServerRPC:
    """The client's handle to a remote server agent.

    ``token`` is the node's ACL secret (the reference's client
    ``acl.token`` config), attached to every RPC so ACL-enabled servers
    authorize the node endpoints.
    """

    def __init__(self, addr: str, timeout: float = 10.0, token: str = ""):
        self.addr = addr.rstrip("/")
        self.timeout = timeout
        self.token = token

    # ------------------------------------------------------------------

    def _call(self, path: str, payload=None, timeout=None):
        # Chaos seam: a request can be lost, erred, delayed (handled inside
        # inject), or duplicated before it ever reaches the wire.
        fault = inject("rpc.call", path=path, addr=self.addr)
        trace.event("seam.rpc.call", path=path)
        if fault is not None:
            if fault.kind == "drop":
                raise RPCError(f"{path}: injected connection drop")
            if fault.kind == "error":
                raise RPCError(f"{path}: 500 injected server error")
        data = json.dumps(payload).encode() if payload is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Nomad-Token"] = self.token

        def post_once():
            req = urllib.request.Request(
                self.addr + path,
                data=data,
                method="POST" if data is not None else "GET",
                headers=headers,
            )
            try:
                with urllib.request.urlopen(
                    req, timeout=timeout or self.timeout
                ) as resp:
                    return json.loads(resp.read() or b"null")
            except urllib.error.HTTPError as exc:
                raise RPCError(
                    f"{path}: {exc.code} {exc.read().decode(errors='replace')}"
                ) from exc
            except urllib.error.URLError as exc:
                raise RPCError(f"{path}: {exc.reason}") from exc

        if fault is not None and fault.kind == "dup":
            # A retransmitted request (lost ack): the server must treat the
            # second copy idempotently; callers see the second response.
            post_once()
        return post_once()

    # ------------------------------------------------------------------
    # The five-method client↔server surface
    # ------------------------------------------------------------------

    def register_node(self, node: Node) -> float:
        out = self._call(
            "/v1/internal/node/register", {"Node": serde.to_wire(node)}
        )
        return float(out["TTL"])

    def heartbeat_node(self, node_id: str) -> float:
        out = self._call(
            "/v1/internal/node/heartbeat", {"NodeID": node_id}
        )
        return float(out["TTL"])

    def update_node_status(self, node_id: str, status: str) -> None:
        self._call(
            "/v1/internal/node/status",
            {"NodeID": node_id, "Status": status},
        )

    def get_client_allocs(
        self, node_id: str, min_index: int = 0, timeout: float = 30.0
    ) -> Tuple[List[Allocation], int]:
        out = self._call(
            "/v1/internal/node/client-allocs",
            {"NodeID": node_id, "MinIndex": min_index, "Wait": timeout},
            # The HTTP timeout must outlast the server-side blocking wait.
            timeout=timeout + self.timeout,
        )
        allocs = [serde.from_wire(w) for w in out["Allocs"]]
        return allocs, int(out["Index"])

    def update_allocs_from_client(self, updates: List[Allocation]) -> None:
        self._call(
            "/v1/internal/node/update-allocs",
            {"Allocs": [serde.to_wire(a) for a in updates]},
        )

    def check_acl_capability(
        self, token: str, kind: str, capability: str,
        namespace: str = "default",
    ) -> bool:
        out = self._call("/v1/internal/acl/check", {
            "Token": token, "Kind": kind, "Capability": capability,
            "Namespace": namespace,
        })
        return bool(out.get("Allowed"))

    def get_volume_source(self, namespace: str, volume_id: str):
        out = self._call("/v1/internal/node/volume-source", {
            "Namespace": namespace, "VolumeID": volume_id,
        })
        return out.get("Source")

    def get_alloc_fs_origin(self, alloc_id: str):
        return self._call("/v1/internal/node/alloc-fs-origin", {
            "AllocID": alloc_id,
        })


# The hint travels inside a JSON error body — stop before quote/brace.
_LEADER_HINT = re.compile(r"leader=([^\s\"'}]+)")


class FailoverRPC:
    """The client's handle to a multi-server control plane.

    Wraps one :class:`HTTPServerRPC` per server address; every call tries
    the current target and, on connection errors or a ``not leader``
    redirect (409 with a ``leader=<addr>`` hint), retargets and retries —
    the client-side half of failover (the reference's client tracks a
    server list from heartbeats and rotates on RPC errors,
    client/servers/manager.go).
    """

    def __init__(
        self,
        addrs: List[str],
        timeout: float = 10.0,
        token: str = "",
        retry_policy: "RetryPolicy | None" = None,
    ):
        assert addrs, "need at least one server address"
        self.token = token
        self.rpcs = {
            a: HTTPServerRPC(a, timeout=timeout, token=token) for a in addrs
        }
        self.addrs = list(addrs)
        self.current = self.addrs[0]
        # Failover budget: enough attempts to visit every server twice
        # (one full rotation may land mid-election), jittered so a fleet
        # of clients doesn't hammer the new leader in lockstep, with a
        # hard deadline so a fully-partitioned client surfaces an error
        # instead of spinning forever.
        self.retry_policy = retry_policy or RetryPolicy(
            base_delay=0.05,
            max_delay=1.0,
            max_attempts=2 * len(self.addrs),
            deadline=max(15.0, 2 * len(self.addrs) * timeout),
            attempt_timeout=timeout,
        )

    def _retarget(self, err: RPCError) -> None:
        hint = _LEADER_HINT.search(str(err))
        if hint and hint.group(1) in self.rpcs:
            self.current = hint.group(1)
            return
        idx = self.addrs.index(self.current)
        self.current = self.addrs[(idx + 1) % len(self.addrs)]

    def _with_failover(self, fn_name: str, *args, **kwargs):
        def attempt():
            return getattr(self.rpcs[self.current], fn_name)(*args, **kwargs)

        def on_retry(n, exc, delay):
            self._retarget(exc)

        try:
            return retry_call(
                attempt,
                policy=self.retry_policy,
                retry_on=(RPCError,),
                on_retry=on_retry,
                description=f"rpc failover {fn_name}",
            )
        except RetryBudgetExceeded as exc:
            # Callers (and tests) match on RPCError; surface the last
            # underlying RPC failure, not the budget wrapper.
            raise exc.__cause__  # type: ignore[misc]

    def register_node(self, node: Node) -> float:
        return self._with_failover("register_node", node)

    def heartbeat_node(self, node_id: str) -> float:
        return self._with_failover("heartbeat_node", node_id)

    def update_node_status(self, node_id: str, status: str) -> None:
        return self._with_failover("update_node_status", node_id, status)

    def get_client_allocs(
        self, node_id: str, min_index: int = 0, timeout: float = 30.0
    ) -> Tuple[List[Allocation], int]:
        return self._with_failover(
            "get_client_allocs", node_id, min_index=min_index, timeout=timeout
        )

    def update_allocs_from_client(self, updates: List[Allocation]) -> None:
        return self._with_failover("update_allocs_from_client", updates)

    def check_acl_capability(self, *args, **kwargs) -> bool:
        return self._with_failover("check_acl_capability", *args, **kwargs)

    def get_volume_source(self, *args, **kwargs):
        return self._with_failover("get_volume_source", *args, **kwargs)

    def get_alloc_fs_origin(self, *args, **kwargs):
        return self._with_failover("get_alloc_fs_origin", *args, **kwargs)
