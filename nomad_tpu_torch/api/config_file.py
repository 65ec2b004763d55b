"""Agent configuration files — HCL load + merge.

Reference: ``command/agent/config.go`` + ``config_parse.go``: agents load
one or more HCL/JSON config files (or directories of them), merge them in
order (later wins), and CLI flags override the result.  This build reuses
the jobspec HCL dialect for the same shape:

    name       = "server-1"
    datacenter = "dc1"
    bind_addr  = "127.0.0.1"
    http_port  = 4646
    data_dir   = "/var/lib/nomad_tpu"

    server {
      enabled        = true
      workers        = 4
      acl_enabled    = true
      peers          = ["http://10.0.0.1:4646", "http://10.0.0.2:4646"]
      node_capacity  = 2048
    }

    client {
      enabled = true
      servers = "http://10.0.0.1:4646"
      token   = "<node acl secret>"
      meta { rack = "r1" }
    }
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

from ..jobspec.hcl import parse_hcl


def load_config_files(paths: List[str]) -> Dict:
    """Parse and merge config files/directories in order (later wins —
    command/agent/config.go Merge)."""
    merged: Dict = {}
    for path in paths:
        if os.path.isdir(path):
            for name in sorted(os.listdir(path)):
                if name.endswith((".hcl", ".json")):
                    _merge(merged, _load_one(os.path.join(path, name)))
        else:
            _merge(merged, _load_one(path))
    return merged


def _load_one(path: str) -> Dict:
    with open(path) as fh:
        text = fh.read()
    if path.endswith(".json"):
        import json

        return json.loads(text)
    return parse_hcl(text)


def _merge(base: Dict, extra: Dict) -> Dict:
    for k, v in extra.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            _merge(base[k], v)
        else:
            base[k] = v
    return base


def apply_config(doc: Dict, agent_config) -> None:
    """Fold a merged config document into an AgentConfig (CLI flags are
    applied afterwards by the caller and win)."""
    ac = agent_config
    ac.name = doc.get("name", ac.name)
    ac.datacenter = doc.get("datacenter", ac.datacenter)
    ac.region = doc.get("region", ac.region)
    ac.http_host = doc.get("bind_addr", ac.http_host)
    ac.http_port = int(doc.get("http_port", ac.http_port))

    srv = doc.get("server") or {}
    if srv:
        ac.server_enabled = bool(srv.get("enabled", ac.server_enabled))
        sc = ac.server_config
        sc.num_workers = int(srv.get("workers", sc.num_workers))
        sc.node_capacity = int(srv.get("node_capacity", sc.node_capacity))
        sc.acl_enabled = bool(srv.get("acl_enabled", sc.acl_enabled))
        # Replication's identity and peer secret have nothing to act on
        # in this package: refused, never ignored.  peers and
        # raft_enabled are read, and Agent refuses them.
        unsupported = [k for k in ("server_id", "cluster_secret")
                       if k in srv]
        if unsupported:
            raise ValueError(
                f"replication ({', '.join(unsupported)}) is not in this "
                "package yet: ROADMAP queue 1 item 6"
            )
        peers = srv.get("peers")
        if peers:
            sc.peers = list(peers)
        sc.raft_enabled = bool(srv.get("raft_enabled", sc.raft_enabled))
        if srv.get("heartbeat_min_ttl"):
            sc.heartbeat_min_ttl = float(srv["heartbeat_min_ttl"])
        if srv.get("heartbeat_max_ttl"):
            sc.heartbeat_max_ttl = float(srv["heartbeat_max_ttl"])
    if doc.get("data_dir"):
        ac.server_config.data_dir = os.path.join(doc["data_dir"], "server")
        ac.client_config.data_dir = os.path.join(doc["data_dir"], "client")

    cli = doc.get("client") or {}
    if cli:
        ac.client_enabled = bool(cli.get("enabled", ac.client_enabled))
        cc = ac.client_config
        if cli.get("servers"):
            ac.server_addr = str(cli["servers"])
        if cli.get("token"):
            ac.client_token = str(cli["token"])
        cc.node_class = cli.get("node_class", cc.node_class)
        meta = cli.get("meta")
        if isinstance(meta, dict):
            cc.meta.update({k: str(v) for k, v in meta.items()})
        if cli.get("artifact_root"):
            cc.artifact_root = str(cli["artifact_root"])
        # host_volume "name" { path = "/export/x" } blocks.
        hv = cli.get("host_volume")
        if isinstance(hv, dict):
            for name, body in hv.items():
                bodies = body if isinstance(body, list) else [body]
                for b in bodies:
                    if isinstance(b, dict) and b.get("path"):
                        cc.host_volumes[name] = str(b["path"])
        # plugin "name" { binary = "/path" } blocks (external drivers).
        pl = cli.get("plugin")
        if isinstance(pl, dict):
            for name, body in pl.items():
                bodies = body if isinstance(body, list) else [body]
                for b in bodies:
                    if isinstance(b, dict) and b.get("binary"):
                        cc.plugins[name] = {"binary": str(b["binary"])}
