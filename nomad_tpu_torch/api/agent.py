"""Agent — server and/or client plus the HTTP API in one process.

Reference: ``command/agent/agent.go`` (NewAgent boots nomad.NewServer and/or
client.NewClient in-process) + ``command/agent/http.go`` (HTTPServer).

A copy of the reference package's ``api/agent.py``.  ``Agent`` takes the
device of its server (default ``"cuda"``, raising without a card); a
client-only agent builds no ``Server`` and touches no device.  A server
agent configured with ``peers`` or ``raft_enabled`` joins a replicated
cluster as a follower (``Server.setup_replication``); each such agent's
server holds its own device and launches kernels only while it leads.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

from ..client import Client, ClientConfig
from ..server import Server, ServerConfig


@dataclass
class AgentConfig:
    name: str = "agent-1"
    region: str = "global"
    datacenter: str = "dc1"
    server_enabled: bool = True
    client_enabled: bool = True
    # Remote server agent address for client-only agents (the wire seam:
    # client/client.go dials servers; here HTTP at /v1/internal/*).
    server_addr: str = ""
    # Node ACL secret attached to every server RPC (client acl.token).
    client_token: str = ""
    http_host: str = "127.0.0.1"
    http_port: int = 0  # 0 = ephemeral
    server_config: ServerConfig = field(default_factory=ServerConfig)
    client_config: ClientConfig = field(default_factory=ClientConfig)


class Agent:
    def __init__(
        self, config: Optional[AgentConfig] = None, device="cuda"
    ):
        self.config = config or AgentConfig()
        self.started_at = 0.0
        self.server: Optional[Server] = None
        self.client: Optional[Client] = None
        if self.config.server_enabled:
            self.server = Server(self.config.server_config, device=device)
        if self.config.client_enabled:
            if self.server is not None:
                server_handle = self.server
            elif self.config.server_addr:
                from .rpc import FailoverRPC, HTTPServerRPC

                addrs = [
                    a.strip()
                    for a in self.config.server_addr.split(",")
                    if a.strip()
                ]
                server_handle = (
                    FailoverRPC(addrs, token=self.config.client_token)
                    if len(addrs) > 1
                    else HTTPServerRPC(
                        addrs[0], token=self.config.client_token
                    )
                )
            else:
                raise ValueError(
                    "client-only agents need --servers <addr> of a server agent"
                )
            self.config.client_config.datacenter = self.config.datacenter
            self.client = Client(server_handle, self.config.client_config)

        from .http_server import HTTPAPIServer

        self.http = HTTPAPIServer(
            self, host=self.config.http_host, port=self.config.http_port
        )
        self.rpc_addr = self.http.addr
        if self.server is not None and (
            self.config.server_config.peers
            or self.config.server_config.raft_enabled
        ):
            # Multi-server: join the peer set as a follower; the election
            # promotes one leader (server/replication.py).  raft_enabled
            # covers the single-server-that-grows case (`server join`).
            self.server.setup_replication(self.rpc_addr)

    def start(self) -> None:
        self.started_at = time.time()
        if self.server is not None:
            self.server.start()
            rep = self.server.replicator
            if rep is not None and self.client is not None:
                # The in-process client registers through direct server
                # calls (no leader-redirect retry on that seam): wait out
                # the first election so its boot writes don't race it.
                deadline = time.time() + 10.0
                while time.time() < deadline and not rep.leader_addr:
                    time.sleep(0.05)
        if self.client is not None:
            # Advertise this agent's HTTP address on the node so servers
            # can forward task-fs/log requests to it (the reference
            # advertises client HTTP addrs the same way).
            self.client.node.attributes = dict(self.client.node.attributes)
            self.client.node.attributes["nomad.advertise.address"] = (
                self.rpc_addr
            )
            self.client.start()
        self.http.start()

    def shutdown(self) -> None:
        if self.client is not None:
            self.client.shutdown()
        if self.server is not None:
            self.server.shutdown()
        self.http.shutdown()

    # ------------------------------------------------------------------

    def member_info(self) -> Dict:
        return {
            "Name": self.config.name,
            "Region": self.config.region,
            "Datacenter": self.config.datacenter,
            "Server": self.server is not None,
            "Client": self.client is not None,
            "Addr": self.rpc_addr,
            "Status": "alive",
        }

    def metrics(self) -> Dict:
        out: Dict = {"uptime_s": round(time.time() - self.started_at, 1)}
        if self.server is not None:
            s = self.server
            out.update(
                {
                    "nomad.broker.total_ready": s.eval_broker.ready_count(),
                    "nomad.broker.total_unacked": s.eval_broker.unacked_count(),
                    "nomad.broker.total_pending": s.eval_broker.pending_count(),
                    "nomad.blocked_evals.total_blocked":
                        s.blocked_evals.blocked_count(),
                    "nomad.plan.queue_depth": s.plan_queue.depth(),
                    "nomad.plan.applied": s.plan_applier.plans_applied,
                    "nomad.plan.partial": s.plan_applier.plans_partial,
                    "nomad.state.nodes": len(s.store.nodes),
                    "nomad.state.jobs": len(s.store.jobs),
                    "nomad.state.allocs": len(s.store.allocs),
                    "nomad.state.evals": len(s.store.evals),
                    "nomad.worker.evals_processed": sum(
                        w.evals_processed for w in s.workers
                    ),
                    "nomad.heartbeat.active": s.heartbeater.tracked(),
                    "nomad.stream.subscribers":
                        s.store.events.subscriber_count(),
                }
            )
            # Coalescer pipeline + matrix transfer + per-kernel cost
            # attribution now ride in as registry pull gauges (registered
            # by Server._register_telemetry_gauges, same key names), and
            # the latency timers (worker.go:245, plan_apply.go:185,370
            # analogs) plus nomad.phase.* trace histograms alongside them.
            out.update(s.metrics.snapshot())
        if self.client is not None:
            out["client.allocs_running"] = self.client.num_allocs()
        return out
