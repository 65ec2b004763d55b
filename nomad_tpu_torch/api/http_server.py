"""HTTP API — the ``/v1`` surface.

Reference: ``command/agent/http.go:252-324`` route registration. JSON over
HTTP; the CLI and external tooling consume this, mirroring the reference's
api/ package contract.

A copy of the reference package's ``api/http_server.py``: the same routes,
JSON shapes and status codes, the raft RPCs of a replicated server (501 on
a server without a replicator) and the not-leader answer (409 with the
leader's address); a caller that hung up mid-request gets no 500 written
after it.  Handlers parked in a stream (event stream, monitor, log
follow) end when the API shuts down; the server's shutdown wakes parked
blocking queries.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple
from urllib.parse import parse_qs, urlparse

from ..jobspec import api_to_job, parse_job
from ..server.admission import RateLimitError
from ..server.replication import NotLeaderError
from ..structs.types import DrainStrategy, SchedulerConfiguration


def _dump(obj: Any, exclude: Tuple[str, ...] = ()) -> Any:
    if obj is None:
        return None
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = dataclasses.asdict(obj)
        for k in exclude:
            d.pop(k, None)
        return d
    if isinstance(obj, list):
        return [_dump(o, exclude) for o in obj]
    if isinstance(obj, dict):
        return {k: _dump(v, exclude) for k, v in obj.items()}
    return obj


class HTTPError(Exception):
    def __init__(
        self, code: int, message: str,
        headers: Optional[Dict[str, str]] = None,
    ):
        super().__init__(message)
        self.code = code
        self.message = message
        self.headers = headers or {}


@dataclasses.dataclass
class RawResponse:
    """A route() result that bypasses JSON serialization — for non-JSON
    content types (Prometheus text exposition, pre-encoded traces)."""

    body: bytes
    content_type: str = "text/plain; charset=utf-8"


class _Listener(ThreadingHTTPServer):
    # socketserver's default backlog is 5: with more callers connecting at
    # once (agents, the CLI, registrations from several threads) the
    # kernel drops their SYNs, and each is retried a second later.
    request_queue_size = 128


class HTTPAPIServer:
    """Routes requests onto the in-process agent (server and/or client)."""

    def __init__(self, agent, host: str = "127.0.0.1", port: int = 0):
        self.agent = agent
        api = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # quiet
                pass

            def _respond(
                self, code: int, payload: Any,
                headers: Optional[Dict[str, str]] = None,
            ) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _handle(self, method: str) -> None:
                try:
                    parsed = urlparse(self.path)
                    multi = parse_qs(parsed.query)
                    query = {k: v[0] for k, v in multi.items()}
                    if parsed.path == "/v1/event/stream" and method == "GET":
                        # NDJSON stream — bypasses the one-shot JSON path.
                        stream_token = self.headers.get(
                            "X-Nomad-Token", query.get("token", "")
                        )
                        api.stream_events(self, multi, token=stream_token)
                        return
                    if parsed.path == "/v1/agent/monitor" and (
                        method == "GET"
                    ):
                        mon_token = self.headers.get(
                            "X-Nomad-Token", query.get("token", "")
                        )
                        api.stream_monitor(self, query, token=mon_token)
                        return
                    if parsed.path.startswith("/v1/client/fs/") and (
                        method == "GET"
                    ):
                        # Raw-byte (possibly streaming) task-fs surface.
                        fs_token = self.headers.get(
                            "X-Nomad-Token", query.get("token", "")
                        )
                        api.serve_client_fs(
                            self, parsed.path, query, token=fs_token
                        )
                        return
                    if parsed.path in ("/", "/ui") and method == "GET":
                        # Minimal operator dashboard (api/ui.py) — the
                        # reference serves its Ember SPA the same way.
                        from .ui import UI_HTML

                        api._raw_respond(
                            self, 200, UI_HTML.encode(),
                            "text/html; charset=utf-8",
                        )
                        return
                    if parsed.path.startswith("/v1/client/exec/") and (
                        method in ("POST", "PUT")
                    ):
                        # NDJSON-framed command execution in a task's
                        # context (alloc exec).
                        ln = int(self.headers.get("Content-Length", 0) or 0)
                        raw = self.rfile.read(ln) if ln else b""
                        exec_body = json.loads(raw) if raw else {}
                        exec_token = self.headers.get(
                            "X-Nomad-Token", query.get("token", "")
                        )
                        api.serve_client_exec(
                            self, parsed.path, query, exec_body,
                            token=exec_token,
                        )
                        return
                    length = int(self.headers.get("Content-Length", 0) or 0)
                    raw = self.rfile.read(length) if length else b""
                    body = json.loads(raw) if raw else None
                    token = self.headers.get(
                        "X-Nomad-Token", query.get("token", "")
                    )
                    result = api.route(
                        method, parsed.path, query, body, token=token,
                        cluster_secret=self.headers.get(
                            "X-Nomad-Cluster-Secret", ""
                        ),
                    )
                    if isinstance(result, RawResponse):
                        api._raw_respond(
                            self, 200, result.body, result.content_type
                        )
                    else:
                        self._respond(200, result)
                except HTTPError as exc:
                    self._respond(
                        exc.code, {"error": exc.message},
                        headers=exc.headers,
                    )
                except (BrokenPipeError, ConnectionResetError):
                    # The caller hung up (an agent stopping mid-query):
                    # there is no one to send a 500 to.
                    pass
                except Exception as exc:  # noqa: BLE001
                    if isinstance(exc, NotLeaderError):
                        self._respond(409, {
                            "error": f"not leader; leader={exc.leader_addr}"
                        })
                    elif isinstance(exc, RateLimitError):
                        # Load-shed submission: 429 + the bucket's actual
                        # deficit as the Retry-After hint (admission.py).
                        self._respond(
                            429, {"error": str(exc)},
                            headers={
                                "Retry-After": f"{exc.retry_after:.3f}"
                            },
                        )
                    else:
                        self._respond(500, {"error": str(exc)})

            def do_GET(self):
                self._handle("GET")

            def do_PUT(self):
                self._handle("PUT")

            def do_POST(self):
                self._handle("POST")

            def do_DELETE(self):
                self._handle("DELETE")

        self.httpd = _Listener((host, port), Handler)
        self.httpd.daemon_threads = True
        self.port = self.httpd.server_address[1]
        self.addr = f"http://{host}:{self.port}"
        self._thread: Optional[threading.Thread] = None
        # Set by shutdown(), which also calls every registered closer: the
        # event-stream, monitor and log-follow loops end.
        self._closing = threading.Event()
        self._closers_lock = threading.Lock()
        self._closers: set = set()

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self.httpd.serve_forever, name="http-api", daemon=True
        )
        self._thread.start()

    def _on_close(self, close: Callable[[], None], add: bool = True) -> None:
        """Register (or drop) a callable that ends a parked stream."""
        with self._closers_lock:
            if add:
                self._closers.add(close)
            else:
                self._closers.discard(close)
        if add and self._closing.is_set():
            close()

    def shutdown(self) -> None:
        self._closing.set()
        with self._closers_lock:
            closers = list(self._closers)
        for close in closers:
            close()
        self.httpd.shutdown()
        self.httpd.server_close()

    # ------------------------------------------------------------------
    # Event stream (nomad/stream/ + /v1/event/stream NDJSON,
    # command/agent/event_endpoint.go)
    # ------------------------------------------------------------------

    def stream_events(self, handler, multi_query: Dict, token: str = "") -> None:
        server = self.agent.server
        if server is None:
            raise HTTPError(501, "agent is not running a server")
        if server.config.acl_enabled:
            acl = server.resolve_token(token)
            if acl is None or not acl.allow_agent("read"):
                raise HTTPError(403, "Permission denied (agent:read)")
        # topic filters: repeated topic=Topic:key params ("*" wildcards).
        topics: Dict[str, list] = {}
        for spec in multi_query.get("topic", ["*:*"]):
            topic, _, key = spec.partition(":")
            topics.setdefault(topic or "*", []).append(key or "*")
        from_index = int(multi_query.get("index", ["0"])[0] or 0)

        sub = server.store.events.subscribe(topics, from_index=from_index)
        self._on_close(sub.close)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/x-ndjson")
            handler.send_header("Connection", "close")
            handler.end_headers()
            while True:
                events = sub.next(timeout=10.0)
                if sub.closed:
                    return
                if not events:
                    # Heartbeat keeps intermediaries from timing the
                    # connection out (the reference sends empty objects).
                    handler.wfile.write(b"{}\n")
                    handler.wfile.flush()
                    continue
                for ev in events:
                    handler.wfile.write(
                        (json.dumps(ev.to_wire()) + "\n").encode()
                    )
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # client went away
        finally:
            sub.close()
            self._on_close(sub.close, add=False)

    # ------------------------------------------------------------------
    # ACL enforcement (reference: per-endpoint ResolveToken + capability
    # checks across nomad/*_endpoint.go; trimmed to a route→capability
    # map here)
    # ------------------------------------------------------------------

    def _require_ns_cap(
        self, server, token: str, namespace: str, cap: str
    ) -> None:
        """Capability check against the namespace of the RESOURCE being
        touched (the route gate can only see the query namespace; bodies
        and looked-up objects carry their own)."""
        if not server.config.acl_enabled:
            return
        acl = server.resolve_token(token)
        if acl is None or not acl.allow_namespace(namespace, cap):
            raise HTTPError(
                403, f"Permission denied ({cap} on {namespace!r})"
            )

    def _require_management(self, server, token: str) -> None:
        """Cluster-wide mutations (namespaces) need a management token
        (namespace_endpoint.go requires one for upsert/delete)."""
        if not server.config.acl_enabled:
            return
        acl = server.resolve_token(token)
        if acl is None or not acl.management:
            raise HTTPError(403, "Permission denied (management only)")

    def _check_acl(
        self, server, method: str, path: str, query: Dict, token: str
    ) -> None:
        from ..acl import CAP_READ_JOB, CAP_SUBMIT_JOB

        acl = server.resolve_token(token)
        if acl is None:
            raise HTTPError(403, "ACL token not found")
        read = method == "GET"
        if path == "/v1/jobs/parse":
            return  # pure function of its input
        if path == "/v1/search":
            return  # per-context checks in the handler (needs the body)
        if path.startswith("/v1/acl"):
            if path == "/v1/acl/token/self":
                return  # any valid token may read itself
            if not acl.management:
                raise HTTPError(403, "Permission denied (management only)")
            return
        if path.startswith("/v1/internal/node") or path == "/v1/nodes" or (
            path.startswith("/v1/node")
        ):
            want = "read" if read else "write"
            if not acl.allow_node(want):
                raise HTTPError(403, f"Permission denied (node:{want})")
            return
        if path.startswith("/v1/operator") or path.startswith("/v1/system"):
            want = "read" if read else "write"
            if not acl.allow_operator(want):
                raise HTTPError(403, f"Permission denied (operator:{want})")
            return
        if path == "/v1/jobs" or path.startswith("/v1/job") or (
            path == "/v1/validate/job"
        ):
            # The query namespace gates list/lookups (store keys are
            # (namespace, id), so the queried ns IS the resource's); write
            # bodies that carry their own Namespace are re-checked against
            # it by the route handlers (_require_ns_cap).
            from ..acl import CAP_DISPATCH_JOB, CAP_SCALE_JOB

            ns = query.get("namespace", "default")
            cap = CAP_READ_JOB if read else CAP_SUBMIT_JOB
            # Anchored on the suffix AFTER a job id (a job literally
            # named "dispatch"/"scale" must not trip these).
            if re.match(r"^/v1/job/.+/dispatch$", path):
                cap = CAP_DISPATCH_JOB
            elif re.match(r"^/v1/job/.+/scale$", path) and not read:
                cap = CAP_SCALE_JOB
            if not acl.allow_namespace(ns, cap):
                raise HTTPError(403, f"Permission denied ({cap})")
            return
        if path.startswith("/v1/allocation") or path.startswith(
            "/v1/evaluation"
        ) or path == "/v1/deployments" or path.startswith(
            "/v1/deployment"
        ) or path.startswith("/v1/scaling") or path.startswith(
            "/v1/volume"
        ):
            if not read and path.startswith("/v1/volume"):
                # register/deregister: handler enforces submit-job on the
                # volume's own namespace.
                return
            if not read and path.startswith("/v1/deployment"):
                # promote/fail/pause: the handler enforces submit-job on
                # the DEPLOYMENT's namespace (the query ns can't see it).
                return
            ns = query.get("namespace", "default")
            if not acl.allow_namespace(ns, CAP_READ_JOB):
                raise HTTPError(403, "Permission denied (read-job)")
            return
        # Agent-level surface (members, metrics, event stream).
        want = "read" if read else "write"
        if not acl.allow_agent(want):
            raise HTTPError(403, f"Permission denied (agent:{want})")

    def _route_acl(
        self, server, method: str, path: str, query: Dict, body: Any,
        token: str,
    ) -> Any:
        from ..structs import serde
        from ..structs.types import ACLPolicy, ACLToken

        if path == "/v1/acl/bootstrap" and method in ("PUT", "POST"):
            try:
                t = server.bootstrap_acl()
            except PermissionError as exc:
                raise HTTPError(400, str(exc))
            return _dump(t)
        if path == "/v1/acl/policies" and method == "GET":
            return [
                {"Name": p.name, "Description": p.description}
                for p in server.store.acl_policies.values()
            ]
        m = re.match(r"^/v1/acl/policy/([^/]+)$", path)
        if m:
            if method == "GET":
                p = server.store.acl_policies.get(m.group(1))
                if p is None:
                    raise HTTPError(404, "policy not found")
                return _dump(p)
            if method in ("PUT", "POST"):
                from ..acl import parse_policy

                rules = (body or {}).get("Rules", "")
                parse_policy(rules)  # validate before committing
                server.store.upsert_acl_policy(
                    server.next_index(),
                    ACLPolicy(
                        name=m.group(1),
                        description=(body or {}).get("Description", ""),
                        rules=rules,
                    ),
                )
                return {}
            if method == "DELETE":
                server.store.delete_acl_policy(
                    server.next_index(), m.group(1)
                )
                return {}
        if path == "/v1/acl/tokens" and method == "GET":
            return [
                _dump(t, exclude=("secret_id",))
                for t in server.store.acl_tokens.values()
            ]
        if path == "/v1/acl/token" and method in ("PUT", "POST"):
            t = ACLToken(
                name=(body or {}).get("Name", ""),
                type=(body or {}).get("Type", "client"),
                policies=list((body or {}).get("Policies", [])),
                create_time=time.time(),
            )
            server.store.upsert_acl_tokens(server.next_index(), [t])
            return _dump(t)
        m = re.match(r"^/v1/acl/token/([^/]+)$", path)
        if m and method == "DELETE":
            server.store.delete_acl_token(server.next_index(), m.group(1))
            return {}
        if path == "/v1/acl/token/self" and method == "GET":
            t = server.store.acl_token_by_secret(token)
            if t is None:
                raise HTTPError(404, "token not found")
            return _dump(t)
        raise HTTPError(404, f"unknown ACL route {path}")

    # ------------------------------------------------------------------
    # Live log monitor (reference: /v1/agent/monitor, command/agent/
    # monitor/monitor.go — streams the agent's own logs at a level)
    # ------------------------------------------------------------------

    def stream_monitor(self, handler, query: Dict, token: str = "") -> None:
        import logging
        import queue as _queue

        server = self.agent.server
        if server is not None:
            if server.config.acl_enabled:
                acl = server.resolve_token(token)
                if acl is None or not acl.allow_agent("read"):
                    raise HTTPError(403, "Permission denied (agent:read)")
        elif self.agent.client is not None:
            # Client-only agent: forward the check to the server — direct
            # node access must not bypass ACLs (same invariant as the fs
            # surface below).
            try:
                allowed = self.agent.client.server.check_acl_capability(
                    token, "agent", "read"
                )
            except Exception as exc:  # noqa: BLE001 — fail closed
                raise HTTPError(502, f"ACL check unavailable: {exc}")
            if not allowed:
                raise HTTPError(403, "Permission denied (agent:read)")

        level = getattr(
            logging, query.get("log_level", "info").upper(), logging.INFO
        )
        q: "_queue.Queue" = _queue.Queue(maxsize=512)

        class _Tap(logging.Handler):
            def emit(self, record):
                try:
                    q.put_nowait({
                        "Time": record.created,
                        "Level": record.levelname,
                        "Name": record.name,
                        "Message": record.getMessage(),
                    })
                except _queue.Full:
                    pass  # slow consumer: drop, never block the logger

        tap = _Tap(level=level)
        root = logging.getLogger()
        root.addHandler(tap)
        # The handler level alone can't see records the root logger drops:
        # with no logging config, the effective level is WARNING and an
        # info/debug monitor would stream nothing.  Lower the root level
        # for the stream's lifetime (the reference's monitor sink does the
        # same); restored below.  Concurrent monitors at different levels
        # keep the lowest until the last one exits — benign over-logging.
        prev_level = root.level
        if level < (root.level or logging.WARNING):
            root.setLevel(level)

        def wake() -> None:
            try:
                q.put_nowait(None)
            except _queue.Full:
                pass

        self._on_close(wake)
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "application/x-ndjson")
            handler.send_header("Connection", "close")
            handler.end_headers()
            while not self._closing.is_set():
                try:
                    rec = q.get(timeout=10.0)
                    if rec is None:
                        break
                    handler.wfile.write(json.dumps(rec).encode() + b"\n")
                except _queue.Empty:
                    handler.wfile.write(b"{}\n")  # keepalive
                handler.wfile.flush()
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass
        finally:
            self._on_close(wake, add=False)
            root.removeHandler(tap)
            root.setLevel(prev_level)

    # ------------------------------------------------------------------
    # Task filesystem + logs (reference: command/agent/fs_endpoint.go
    # /v1/client/fs/* — served by the agent holding the alloc, forwarded
    # by servers to the node's advertised agent address; the reference
    # forwards over the reverse yamux session, nomad/client_rpc.go)
    # ------------------------------------------------------------------

    def _authorize_alloc_ns(self, alloc_id: str, cap: str, token: str) -> None:
        """Resolve the ALLOCATION's namespace (a query parameter would let
        a token authorized in one namespace touch another's tasks) and
        enforce ``cap`` on it — via local token resolution on server
        agents, or a forwarded capability check on client-only agents
        (the reference's clients resolve ACLs via server RPC too).
        Shared by the fs/logs and exec surfaces."""
        client = self.agent.client
        server = self.agent.server
        ns = None
        if client is not None and alloc_id in client.allocs:
            ns = client.allocs[alloc_id].alloc.namespace
        elif server is not None:
            found = server.store.alloc_by_id(alloc_id)
            if found is not None:
                ns = found.namespace
        if ns is None:
            raise HTTPError(404, f"unknown allocation {alloc_id}")
        if server is not None:
            if server.config.acl_enabled:
                acl = server.resolve_token(token)
                if acl is None or not acl.allow_namespace(ns, cap):
                    raise HTTPError(403, f"Permission denied ({cap})")
        elif client is not None:
            # Reaching the node agent directly must not bypass the ACLs
            # the server enforces; fail closed when the check is down.
            try:
                allowed = client.server.check_acl_capability(
                    token, "namespace", cap, ns
                )
            except Exception as exc:  # noqa: BLE001
                raise HTTPError(502, f"ACL check unavailable: {exc}")
            if not allowed:
                raise HTTPError(403, f"Permission denied ({cap})")

    def serve_client_fs(
        self, handler, path: str, query: Dict, token: str = ""
    ) -> None:
        from ..acl import CAP_READ_FS, CAP_READ_LOGS

        cap = CAP_READ_LOGS if "/logs/" in path else CAP_READ_FS

        m = re.match(r"^/v1/client/fs/(ls|cat|logs)/([^/?]+)$", path)
        if not m:
            raise HTTPError(404, f"unknown fs route {path}")
        op, alloc_id = m.group(1), m.group(2)
        self._authorize_alloc_ns(alloc_id, cap, token)
        client = self.agent.client

        if client is None or alloc_id not in client.allocs:
            self._forward_client_fs(handler, path, query, alloc_id, token)
            return

        from ..client.client import AllocFSError

        try:
            if op == "ls":
                body = json.dumps(
                    client.list_files(alloc_id, query.get("path", ""))
                ).encode()
                self._raw_respond(handler, 200, body, "application/json")
                return
            if op == "cat":
                data = client.read_file(
                    alloc_id,
                    query.get("path", ""),
                    offset=int(query.get("offset", "0")),
                    limit=int(query.get("limit", str(1 << 20))),
                )
                self._raw_respond(
                    handler, 200, data, "application/octet-stream"
                )
                return
            # logs: tail + optional follow stream.  Positions are tracked
            # absolutely so bytes appended between the initial read and
            # the follow loop are never dropped.
            import os as _os

            rel = client.task_log_path(
                query.get("task", ""), query.get("type", "stdout")
            )
            offset = int(query.get("offset", "-65536"))
            follow = query.get("follow", "") in ("true", "1")
            target = client._resolve_fs_path(alloc_id, rel)
            size = _os.path.getsize(target)
            pos = max(0, size + offset) if offset < 0 else min(offset, size)
            data = client.read_file(
                alloc_id, rel, offset=pos, limit=max(0, size - pos)
            )
            pos += len(data)
        except AllocFSError as exc:
            raise HTTPError(exc.code, str(exc))
        except OSError as exc:
            raise HTTPError(404, str(exc))

        if not follow:
            self._raw_respond(handler, 200, data, "text/plain")
            return
        # Follow mode: chunked growth polling until the reader hangs up
        # (the reference's StreamFile frames; plain byte chunks here).
        handler.send_response(200)
        handler.send_header("Content-Type", "text/plain")
        handler.send_header("Connection", "close")
        handler.end_headers()
        try:
            handler.wfile.write(data)
            handler.wfile.flush()
            while not self._closing.is_set():
                size = _os.path.getsize(target)
                if size > pos:
                    chunk = client.read_file(
                        alloc_id, rel, offset=pos, limit=size - pos
                    )
                    handler.wfile.write(chunk)
                    handler.wfile.flush()
                    pos += len(chunk)
                time.sleep(0.25)
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass  # reader went away / alloc dir removed
        except Exception:  # noqa: BLE001 — alloc GC'd mid-follow
            pass

    def serve_client_exec(
        self, handler, path: str, query: Dict, body: Dict, token: str = ""
    ) -> None:
        """Run a command in a task's context and stream NDJSON frames
        ({"stdout": b64} / {"stderr": b64} / {"exit": code}) — the
        alloc-exec surface (plugins/drivers/execstreaming.go; the
        reference's live pty bidi is trimmed to stdin-upfront over plain
        HTTP, which covers piped stdin and one-shot commands)."""
        import base64
        import subprocess

        from ..acl import CAP_ALLOC_EXEC

        m = re.match(r"^/v1/client/exec/([^/?]+)$", path)
        if not m:
            raise HTTPError(404, f"unknown exec route {path}")
        alloc_id = m.group(1)
        client = self.agent.client
        self._authorize_alloc_ns(alloc_id, CAP_ALLOC_EXEC, token)

        if client is None or alloc_id not in client.allocs:
            self._forward_client_exec(handler, path, body, alloc_id, token)
            return

        task = body.get("Task", "")
        argv = [str(a) for a in body.get("Cmd") or []]
        if not argv:
            raise HTTPError(400, "missing Cmd")
        ar = client.allocs[alloc_id]
        if not task and len(ar.runners) == 1:
            task = next(iter(ar.runners))
        runner = ar.runners.get(task)
        if runner is None:
            raise HTTPError(404, f"unknown task {task!r}")
        task_dir = runner.task_dir
        env = dict(os.environ)
        env.update({
            k: str(v) for k, v in (runner.task.env or {}).items()
        })
        stdin = base64.b64decode(body.get("Stdin", "") or "")

        handler.send_response(200)
        handler.send_header("Content-Type", "application/x-ndjson")
        handler.send_header("Connection", "close")
        handler.end_headers()

        def frame(obj) -> None:
            handler.wfile.write((json.dumps(obj) + "\n").encode())
            handler.wfile.flush()

        try:
            proc = subprocess.Popen(
                argv, cwd=task_dir, env=env,
                stdin=subprocess.PIPE,
                stdout=subprocess.PIPE,
                stderr=subprocess.PIPE,
            )
        except OSError as exc:
            frame({"error": str(exc)})
            return
        try:
            out, err = proc.communicate(stdin, timeout=float(
                body.get("Timeout", 300.0)
            ))
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
            frame({"error": "command timed out"})
        try:
            for chunk_name, data in (("stdout", out), ("stderr", err)):
                for i in range(0, len(data), 65536):
                    frame({
                        chunk_name: base64.b64encode(
                            data[i:i + 65536]
                        ).decode()
                    })
            frame({"exit": proc.returncode})
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass

    def _forward_client_exec(
        self, handler, path: str, body: Dict, alloc_id: str, token: str
    ) -> None:
        """Server leg: forward the exec request to the node agent holding
        the alloc and stream its NDJSON response through."""
        import urllib.error
        import urllib.request

        addr = self._node_agent_addr(alloc_id)
        headers = {"Content-Type": "application/json"}
        if token:
            headers["X-Nomad-Token"] = token
        req = urllib.request.Request(
            f"{addr}{path}", data=json.dumps(body).encode(),
            method="POST", headers=headers,
        )
        try:
            upstream = urllib.request.urlopen(req, timeout=330)
        except urllib.error.HTTPError as exc:
            raise HTTPError(exc.code, exc.read().decode(errors="replace"))
        with upstream:
            handler.send_response(upstream.status)
            handler.send_header("Content-Type", "application/x-ndjson")
            handler.send_header("Connection", "close")
            handler.end_headers()
            try:
                while True:
                    chunk = upstream.read1(65536)
                    if not chunk:
                        break
                    handler.wfile.write(chunk)
                    handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

    def _node_agent_addr(self, alloc_id: str) -> str:
        """Resolve the HTTP address of the node agent holding an alloc —
        the shared first leg of every server→client forward (fs/logs,
        exec, restart/signal; fs_endpoint.go forwarding)."""
        server = self.agent.server
        if server is None:
            raise HTTPError(404, f"allocation {alloc_id} not on this agent")
        alloc = server.store.alloc_by_id(alloc_id)
        if alloc is None:
            raise HTTPError(404, f"unknown allocation {alloc_id}")
        from ..state.matrix import node_attributes

        node = server.store.node_by_id(alloc.node_id)
        addr = (
            node_attributes(node).get("nomad.advertise.address", "")
            if node is not None else ""
        )
        if not addr or addr == self.addr:
            raise HTTPError(
                404, f"allocation {alloc_id} has no reachable node agent"
            )
        return addr

    def _forward_client_alloc_op(self, path: str, body, token: str):
        """Server leg of restart/signal: POST through to the node agent."""
        import urllib.error
        import urllib.request

        m = re.match(r"^/v1/client/allocation/([^/]+)/", path)
        alloc_id = m.group(1) if m else ""
        addr = self._node_agent_addr(alloc_id)
        headers = {"Content-Type": "application/json"}
        if token:
            headers["X-Nomad-Token"] = token
        req = urllib.request.Request(
            f"{addr}{path}", data=json.dumps(body or {}).encode(),
            method="POST", headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as exc:
            try:
                msg = json.loads(exc.read()).get("error", str(exc))
            except Exception:  # noqa: BLE001
                msg = str(exc)
            raise HTTPError(exc.code, msg)

    def _forward_client_fs(
        self, handler, path: str, query: Dict, alloc_id: str, token: str
    ) -> None:
        """Server-side forwarding: stream the node agent's response
        through (fs_endpoint.go forwarding leg)."""
        import urllib.error
        import urllib.parse
        import urllib.request

        addr = self._node_agent_addr(alloc_id)
        qs = urllib.parse.urlencode(query)
        req = urllib.request.Request(
            f"{addr}{path}?{qs}",
            headers={"X-Nomad-Token": token} if token else {},
        )
        try:
            # Generous timeout: follow-mode streams are idle between chunks.
            upstream = urllib.request.urlopen(req, timeout=300)
        except urllib.error.HTTPError as exc:
            raise HTTPError(exc.code, exc.read().decode(errors="replace"))
        with upstream:
            handler.send_response(upstream.status)
            handler.send_header(
                "Content-Type",
                upstream.headers.get("Content-Type", "text/plain"),
            )
            handler.send_header("Connection", "close")
            handler.end_headers()
            try:
                while True:
                    # read1: pass chunks through as they arrive (read(n)
                    # would stall a live follow stream until n bytes).
                    chunk = upstream.read1(65536)
                    if not chunk:
                        break
                    handler.wfile.write(chunk)
                    handler.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, OSError):
                pass

    @staticmethod
    def _raw_respond(handler, code: int, body: bytes, ctype: str) -> None:
        handler.send_response(code)
        handler.send_header("Content-Type", ctype)
        handler.send_header("Content-Length", str(len(body)))
        handler.end_headers()
        handler.wfile.write(body)

    # ------------------------------------------------------------------
    # Routing (http.go:252-324)
    # ------------------------------------------------------------------

    def route(
        self, method: str, path: str, query: Dict, body: Any,
        token: str = "", cluster_secret: str = "",
    ) -> Any:
        server = self.agent.server
        # Alloc lifecycle ops (`alloc restart` / `alloc signal`;
        # nomad/client_rpc.go forwarding → client Allocations.Restart/
        # Signal): served by the node agent holding the alloc, forwarded
        # by servers like the fs/exec surfaces.
        m = re.match(r"^/v1/client/allocation/([^/]+)/(restart|signal)$",
                     path)
        if m and method in ("PUT", "POST"):
            from ..acl import CAP_ALLOC_LIFECYCLE

            alloc_id, verb = m.group(1), m.group(2)
            self._authorize_alloc_ns(alloc_id, CAP_ALLOC_LIFECYCLE, token)
            client = self.agent.client
            if client is not None and alloc_id in client.allocs:
                ar = client.allocs[alloc_id]
                task = (body or {}).get("Task", "")
                if verb == "restart":
                    return {"Restarted": ar.restart_tasks(task)}
                import signal as _signal

                sig = (body or {}).get("Signal", "SIGTERM")
                try:
                    signum = (
                        int(sig) if str(sig).isdigit()
                        else int(_signal.Signals[str(sig).upper()])
                    )
                except KeyError:
                    raise HTTPError(400, f"unknown signal {sig!r}")
                out = ar.signal_tasks(signum, task)
                return {"Signalled": out["signalled"],
                        "Errors": out["errors"]}
            return self._forward_client_alloc_op(path, body, token)
        # Client-local surface: served by any agent running a client,
        # including client-only agents with no server to route through.
        if path == "/v1/client/stats" and method == "GET":
            if self.agent.client is None:
                raise HTTPError(501, "agent is not running a client")
            if server is not None and server.config.acl_enabled:
                acl = server.resolve_token(token)
                if acl is None or not acl.allow_node("read"):
                    raise HTTPError(403, "Permission denied (node:read)")
            elif self.agent.client is not None and server is None:
                try:
                    if not self.agent.client.server.check_acl_capability(
                        token, "node", "read"
                    ):
                        raise HTTPError(403, "Permission denied (node:read)")
                except HTTPError:
                    raise
                except Exception as exc:  # noqa: BLE001 — fail closed
                    raise HTTPError(502, f"ACL check unavailable: {exc}")
            return self.agent.client.host_stats()
        if server is None:
            raise HTTPError(501, "agent is not running a server")
        store = server.store

        # ---- consensus stream (server↔server; replication.py) ----
        if path.startswith("/v1/internal/raft/"):
            rep = store.replicator
            if rep is None:
                raise HTTPError(501, "server is not running replication")
            # Peer authentication: an unauthenticated snapshot-install
            # would let any caller replace the whole cluster state.  A
            # configured cluster_secret must match; with ACLs on and no
            # secret, a management token is accepted instead.
            want = server.config.cluster_secret
            if want:
                import hmac

                if not hmac.compare_digest(cluster_secret, want):
                    raise HTTPError(403, "bad or missing cluster secret")
            elif server.config.acl_enabled:
                acl = server.resolve_token(token)
                if acl is None or not acl.management:
                    raise HTTPError(
                        403,
                        "raft RPCs require a cluster_secret or a "
                        "management token",
                    )
            if path == "/v1/internal/raft/append":
                return rep.handle_append(body or {})
            if path == "/v1/internal/raft/vote":
                return rep.handle_vote(body or {})
            if path == "/v1/internal/raft/snapshot":
                return rep.handle_snapshot_install(body or {})
            if path == "/v1/internal/raft/stats":
                return rep.stats()
            raise HTTPError(404, f"unknown raft RPC {path}")

        # ---- leader gate: writes (and node RPCs) only serve on the leader
        # (the reference forwards to the leader, nomad/rpc.go forward; we
        # redirect — FailoverRPC/CLI follow the hint) ----
        # Any server can answer capability checks (ACL tables replicate).
        if path == "/v1/internal/acl/check":
            return {"Allowed": server.check_acl_capability(
                (body or {}).get("Token", ""),
                (body or {}).get("Kind", "agent"),
                (body or {}).get("Capability", "read"),
                (body or {}).get("Namespace", "default"),
            )}

        rep = store.replicator
        if rep is not None and not rep.is_leader:
            is_write = method in ("PUT", "POST", "DELETE") and path not in (
                "/v1/jobs/parse",
            )
            if is_write or path.startswith("/v1/internal/"):
                raise HTTPError(
                    409, f"not leader; leader={rep.leader_addr}"
                )

        # ---- ACL enforcement (nomad/acl.go resolution + per-endpoint
        # capability checks; anonymous policy when no token) ----
        if server.config.acl_enabled and path != "/v1/acl/bootstrap":
            self._check_acl(server, method, path, query, token)

        # ---- ACL endpoints (nomad/acl_endpoint.go) ----
        if path.startswith("/v1/acl"):
            return self._route_acl(server, method, path, query, body, token)

        # ---- internal node RPCs (client↔server wire; api/rpc.py peer) ----
        if path.startswith("/v1/internal/"):
            from ..structs import serde

            if path == "/v1/internal/node/register":
                node = serde.from_wire(body["Node"])
                return {"TTL": server.register_node(node)}
            if path == "/v1/internal/node/heartbeat":
                return {"TTL": server.heartbeat_node(body["NodeID"])}
            if path == "/v1/internal/node/status":
                server.update_node_status(body["NodeID"], body["Status"])
                return {}
            if path == "/v1/internal/node/client-allocs":
                wait = min(float(body.get("Wait", 30.0)), 60.0)
                allocs, index = server.get_client_allocs(
                    body["NodeID"],
                    min_index=int(body.get("MinIndex", 0)),
                    timeout=wait,
                )
                return {
                    "Allocs": [serde.to_wire(a) for a in allocs],
                    "Index": index,
                }
            if path == "/v1/internal/node/update-allocs":
                updates = [serde.from_wire(w) for w in body["Allocs"]]
                server.update_allocs_from_client(updates)
                return {}
            if path == "/v1/internal/node/volume-source":
                return {"Source": server.get_volume_source(
                    body.get("Namespace", "default"), body["VolumeID"]
                )}
            if path == "/v1/internal/node/alloc-fs-origin":
                return server.get_alloc_fs_origin(body["AllocID"])
            raise HTTPError(404, f"unknown internal RPC {path}")

        if path == "/v1/jobs" and method == "GET":
            prefix = query.get("prefix", "")
            ns = query.get("namespace", "default")
            return [
                self._job_stub(j)
                for j in store.all_jobs()
                if j.id.startswith(prefix) and j.namespace == ns
            ]
        if path == "/v1/jobs" and method in ("PUT", "POST"):
            payload = (body or {}).get("Job", body)
            if payload is None:
                raise HTTPError(400, "missing job")
            job = api_to_job(payload)
            # The body carries its own namespace — re-check against IT.
            from ..acl import CAP_SUBMIT_JOB

            self._require_ns_cap(server, token, job.namespace, CAP_SUBMIT_JOB)
            try:
                ev = server.submit_job(job)
            except ValueError as exc:
                raise HTTPError(400, str(exc))
            return {"EvalID": ev.id if ev else "", "JobModifyIndex":
                    store.job_by_id(job.namespace, job.id).modify_index}
        if path == "/v1/validate/job" and method in ("PUT", "POST"):
            # Admission dry run (nomad/job_endpoint.go Validate): mutate +
            # validate without registering.
            from ..server.admission import admit

            payload = (body or {}).get("Job", body)
            if payload is None:
                raise HTTPError(400, "missing job")
            try:
                job = api_to_job(payload)
                admit(job)
            except ValueError as exc:
                return {
                    "Valid": False,
                    "ValidationErrors": str(exc).split("; "),
                }
            except (TypeError, AttributeError, KeyError) as exc:
                # Type-malformed payloads (a string where a list belongs)
                # are invalid input, not server errors.
                return {
                    "Valid": False,
                    "ValidationErrors": [f"malformed job payload: {exc}"],
                }
            return {"Valid": True, "ValidationErrors": []}
        if path == "/v1/jobs/parse" and method == "POST":
            hcl = (body or {}).get("JobHCL", "")
            if not hcl:
                raise HTTPError(400, "missing JobHCL")
            return _dump(parse_job(hcl))

        m = re.match(r"^/v1/job/(.+)/plan$", path)
        if m and method in ("PUT", "POST"):
            payload = (body or {}).get("Job", body)
            if payload is None:
                raise HTTPError(400, "missing job")
            job = api_to_job(payload)
            if job.id != m.group(1):
                raise HTTPError(400, "job id does not match URL")
            from ..acl import CAP_SUBMIT_JOB

            self._require_ns_cap(server, token, job.namespace, CAP_SUBMIT_JOB)
            return server.plan_job(
                job, diff=bool((body or {}).get("Diff", False))
            )
        m = re.match(r"^/v1/job/(.+)/allocations$", path)
        if m and method == "GET":
            ns = query.get("namespace", "default")
            return _dump(store.allocs_by_job(ns, m.group(1)), exclude=("job",))
        m = re.match(r"^/v1/job/(.+)/evaluations$", path)
        if m and method == "GET":
            ns = query.get("namespace", "default")
            return _dump(store.evals_by_job(ns, m.group(1)))
        m = re.match(r"^/v1/job/(.+)/dispatch$", path)
        if m and method in ("PUT", "POST"):
            import base64

            ns = query.get("namespace", "default")
            from ..acl import CAP_DISPATCH_JOB

            self._require_ns_cap(server, token, ns, CAP_DISPATCH_JOB)
            try:
                # binascii.Error (bad base64) subclasses ValueError.
                payload = base64.b64decode(
                    (body or {}).get("Payload", "") or ""
                )
                child, ev = server.dispatch_job(
                    ns, m.group(1), payload, (body or {}).get("Meta") or {}
                )
            except ValueError as exc:
                raise HTTPError(400, str(exc))
            return {
                "DispatchedJobID": child.id,
                "EvalID": ev.id if ev else "",
                "Index": store.latest_index,
            }
        m = re.match(r"^/v1/job/(.+)/versions$", path)
        if m and method == "GET":
            ns = query.get("namespace", "default")
            versions = store.job_versions.get((ns, m.group(1)))
            if not versions:
                raise HTTPError(404, "job not found")
            return {
                "Versions": [_dump(v) for v in reversed(versions)],
            }
        m = re.match(r"^/v1/job/(.+)/revert$", path)
        if m and method in ("PUT", "POST"):
            ns = (body or {}).get("Namespace", query.get("namespace", "default"))
            from ..acl import CAP_SUBMIT_JOB

            self._require_ns_cap(server, token, ns, CAP_SUBMIT_JOB)
            to_version = (body or {}).get("JobVersion")
            ev = server.revert_job(
                ns, m.group(1),
                int(to_version) if to_version is not None else None,
            )
            if ev is None:
                raise HTTPError(404, "job or target version not found")
            return {"EvalID": ev.id, "JobModifyIndex": store.latest_index}
        m = re.match(r"^/v1/job/(.+)/scale$", path)
        if m:
            ns = query.get("namespace", "default")
            if method == "GET":
                # Job.ScaleStatus: per-group counts + events.
                job = store.job_by_id(ns, m.group(1))
                if job is None:
                    raise HTTPError(404, "job not found")
                groups = {}
                job_allocs = store.allocs_by_job(ns, job.id)
                for tg in job.task_groups:
                    running = sum(
                        1 for a in job_allocs
                        if a.task_group == tg.name
                        and not a.terminal_status()
                    )
                    groups[tg.name] = {
                        "Desired": tg.count,
                        "Running": running,
                        "Events": [
                            _dump(e) for e in reversed(
                                store.scaling_events.get(
                                    (ns, job.id, tg.name), []
                                )
                            )
                        ],
                    }
                return {"JobID": job.id, "JobStopped": job.stop,
                        "TaskGroups": groups}
            if method in ("PUT", "POST"):
                ns = (body or {}).get("Namespace", ns)
                from ..acl import CAP_SCALE_JOB

                self._require_ns_cap(server, token, ns, CAP_SCALE_JOB)
                target = (body or {}).get("Target") or {}
                group = target.get("Group", "")
                count = (body or {}).get("Count")
                try:
                    ev = server.scale_job(
                        ns, m.group(1), group,
                        int(count) if count is not None else None,
                        message=(body or {}).get("Message", ""),
                        error=bool((body or {}).get("Error", False)),
                        meta=(body or {}).get("Meta") or {},
                    )
                except ValueError as exc:
                    raise HTTPError(400, str(exc))
                return {"EvalID": ev.id if ev else "",
                        "Index": store.latest_index}
        m = re.match(r"^/v1/job/(.+)/deployments$", path)
        if m and method == "GET":
            ns = query.get("namespace", "default")
            deps = [
                d for d in store.deployments.values()
                if d.namespace == ns and d.job_id == m.group(1)
            ]
            deps.sort(key=lambda d: d.create_index, reverse=True)
            return _dump(deps)
        m = re.match(r"^/v1/job/(.+)/deployment$", path)
        if m and method == "GET":
            ns = query.get("namespace", "default")
            dep = store.latest_deployment_by_job(ns, m.group(1))
            return _dump(dep)
        m = re.match(r"^/v1/job/(.+)/summary$", path)
        if m and method == "GET":
            ns = query.get("namespace", "default")
            summary = store.job_summaries.get((ns, m.group(1)))
            if summary is None:
                raise HTTPError(404, "job not found")
            return {
                "JobID": summary.job_id,
                "Namespace": summary.namespace,
                "Summary": summary.summary,
            }
        # Bare job lookup LAST: the greedy id capture would otherwise
        # swallow the suffixed routes above.
        m = re.match(r"^/v1/job/(.+)$", path)
        if m:
            ns = query.get("namespace", "default")
            job = store.job_by_id(ns, m.group(1))
            if method == "GET":
                if job is None:
                    raise HTTPError(404, "job not found")
                return _dump(job)
            if method == "DELETE":
                purge = query.get("purge", "") in ("true", "1")
                ev = server.deregister_job(ns, m.group(1), purge=purge)
                if ev is None:
                    raise HTTPError(404, "job not found")
                return {"EvalID": ev.id}

        if path == "/v1/nodes" and method == "GET":
            return [
                self._node_stub(n) for n in store.nodes.values()
            ]
        m = re.match(r"^/v1/node/([^/]+)$", path)
        if m and method == "GET":
            node = store.node_by_id(m.group(1))
            if node is None:
                raise HTTPError(404, "node not found")
            return _dump(node)
        m = re.match(r"^/v1/node/([^/]+)/allocations$", path)
        if m and method == "GET":
            return _dump(store.allocs_by_node(m.group(1)), exclude=("job",))
        m = re.match(r"^/v1/node/([^/]+)/drain$", path)
        if m and method in ("PUT", "POST"):
            spec = (body or {}).get("DrainSpec")
            strategy = None
            if spec is not None:
                strategy = DrainStrategy(
                    deadline=float(spec.get("Deadline", 3600.0)),
                    ignore_system_jobs=bool(
                        spec.get("IgnoreSystemJobs", False)
                    ),
                )
            server.update_node_drain(
                m.group(1), strategy,
                mark_eligible=bool((body or {}).get("MarkEligible", False)),
            )
            return {"NodeModifyIndex": store.latest_index}
        m = re.match(r"^/v1/node/([^/]+)/eligibility$", path)
        if m and method in ("PUT", "POST"):
            elig = (body or {}).get("Eligibility", "eligible")
            server.update_node_eligibility(m.group(1), elig)
            return {"NodeModifyIndex": store.latest_index}

        if path == "/v1/evaluations" and method == "GET":
            ns = query.get("namespace", "default")
            return _dump([
                e for e in store.evals.values() if e.namespace == ns
            ])
        m = re.match(r"^/v1/evaluation/([^/]+)$", path)
        if m and method == "GET":
            ev = store.eval_by_id(m.group(1))
            if ev is None:
                raise HTTPError(404, "eval not found")
            from ..acl import CAP_READ_JOB

            self._require_ns_cap(server, token, ev.namespace, CAP_READ_JOB)
            return _dump(ev)
        m = re.match(r"^/v1/evaluation/([^/]+)/allocations$", path)
        if m and method == "GET":
            ev = store.eval_by_id(m.group(1))
            if ev is None:
                raise HTTPError(404, "eval not found")
            from ..acl import CAP_READ_JOB

            self._require_ns_cap(server, token, ev.namespace, CAP_READ_JOB)
            return _dump(store.allocs_by_eval(m.group(1)), exclude=("job",))

        if path == "/v1/allocations" and method == "GET":
            ns = query.get("namespace", "default")
            return _dump([
                a for a in store.allocs.values() if a.namespace == ns
            ], exclude=("job",))
        m = re.match(r"^/v1/allocation/([^/]+)$", path)
        if m and method == "GET":
            alloc = store.alloc_by_id(m.group(1))
            if alloc is None:
                raise HTTPError(404, "alloc not found")
            from ..acl import CAP_READ_JOB

            self._require_ns_cap(
                server, token, alloc.namespace, CAP_READ_JOB
            )
            return _dump(alloc, exclude=("job",))
        m = re.match(r"^/v1/allocation/([^/]+)/stop$", path)
        if m and method in ("PUT", "POST"):
            ev = server.stop_alloc(m.group(1))
            if ev is None:
                raise HTTPError(404, "alloc not found")
            return {"EvalID": ev.id}

        # ---- deployments (nomad/deployment_endpoint.go: List :446,
        # Promote :118, Fail, Pause) ----
        if path == "/v1/deployments" and method == "GET":
            ns = query.get("namespace", "default")
            prefix = query.get("prefix", "")
            deps = [
                d for d in store.deployments.values()
                if d.namespace == ns and d.id.startswith(prefix)
            ]
            deps.sort(key=lambda d: d.create_index, reverse=True)
            return _dump(deps)
        m = re.match(r"^/v1/deployment/([^/]+)$", path)
        if m and method == "GET":
            dep = store.deployment_by_id(m.group(1))
            if dep is None:
                raise HTTPError(404, "deployment not found")
            from ..acl import CAP_READ_JOB

            self._require_ns_cap(server, token, dep.namespace, CAP_READ_JOB)
            return _dump(dep)
        m = re.match(r"^/v1/deployment/([^/]+)/allocations$", path)
        if m and method == "GET":
            dep = store.deployment_by_id(m.group(1))
            if dep is None:
                raise HTTPError(404, "deployment not found")
            from ..acl import CAP_READ_JOB

            self._require_ns_cap(server, token, dep.namespace, CAP_READ_JOB)
            return _dump([
                a for a in store.allocs.values()
                if a.deployment_id == dep.id
            ], exclude=("job",))
        m = re.match(r"^/v1/deployment/([^/]+)/(promote|fail|pause)$", path)
        if m and method in ("PUT", "POST"):
            dep = store.deployment_by_id(m.group(1))
            if dep is None:
                raise HTTPError(404, "deployment not found")
            from ..acl import CAP_SUBMIT_JOB

            self._require_ns_cap(server, token, dep.namespace, CAP_SUBMIT_JOB)
            verb = m.group(2)
            if not dep.active():
                raise HTTPError(
                    400, f"cannot {verb} a terminal deployment "
                    f"({dep.status})"
                )
            if verb == "promote":
                groups = (body or {}).get("Groups")
                if (body or {}).get("All") or not groups:
                    groups = None  # promote every canary group
                if not dep.requires_promotion():
                    raise HTTPError(400, "deployment has no canaries to promote")
                server.promote_deployment(dep.id, groups)
            elif verb == "fail":
                server.fail_deployment(
                    dep.id, "Deployment marked as failed by operator"
                )
            else:
                server.pause_deployment(
                    dep.id, bool((body or {}).get("Pause", True))
                )
            return {"DeploymentModifyIndex": store.latest_index,
                    "Index": store.latest_index}

        # ---- volumes (nomad/csi_endpoint.go trimmed to the plugin-less
        # registered-volume analog) ----
        if path == "/v1/volumes":
            ns = query.get("namespace", "default")
            if method == "GET":
                return _dump(sorted(
                    (v for (vns, _), v in store.volumes.items()
                     if vns == ns),
                    key=lambda v: v.id,
                ))
            if method in ("PUT", "POST"):
                from ..structs.types import Volume

                spec = (body or {}).get("Volume", body) or {}
                vol = Volume(
                    id=spec.get("ID", spec.get("id", "")),
                    name=spec.get("Name", spec.get("name", "")),
                    namespace=spec.get(
                        "Namespace", spec.get("namespace", ns)
                    ),
                    source=spec.get("Source", spec.get("source", "")),
                    access_mode=spec.get(
                        "AccessMode",
                        spec.get("access_mode", "single-node-writer"),
                    ),
                    attachment_mode=spec.get(
                        "AttachmentMode",
                        spec.get("attachment_mode", "file-system"),
                    ),
                    capacity_mb=int(spec.get(
                        "CapacityMB", spec.get("capacity_mb", 0)
                    )),
                )
                from ..acl import CAP_SUBMIT_JOB

                self._require_ns_cap(
                    server, token, vol.namespace, CAP_SUBMIT_JOB
                )
                store.upsert_volume(server.next_index(), vol)
                return {"ID": vol.id, "Index": store.latest_index}
        m = re.match(r"^/v1/volume/([^/]+)$", path)
        if m:
            ns = query.get("namespace", "default")
            vol = store.volume_by_id(ns, m.group(1))
            if vol is None:
                raise HTTPError(404, "volume not found")
            if method == "GET":
                return _dump(vol)
            if method == "DELETE":
                from ..acl import CAP_SUBMIT_JOB

                self._require_ns_cap(
                    server, token, vol.namespace, CAP_SUBMIT_JOB
                )
                try:
                    store.delete_volume(server.next_index(), ns, m.group(1))
                except ValueError as exc:
                    raise HTTPError(409, str(exc))
                return {}

        # ---- scaling policies (nomad/scaling_endpoint.go) ----
        if path == "/v1/scaling/policies" and method == "GET":
            ns = query.get("namespace", "default")
            return [
                {
                    "Namespace": pns, "JobID": jid, "Group": group,
                    "Policy": _dump(pol),
                }
                for (pns, jid, group), pol in sorted(
                    store.scaling_policies.items()
                )
                if pns == ns
            ]

        # ---- system (nomad/system_endpoint.go) ----
        if path == "/v1/system/gc" and method in ("PUT", "POST"):
            server.system_gc()
            return {}

        # ---- membership (nomad/serf.go join; operator_endpoint.go
        # RaftRemovePeer) ----
        if path == "/v1/operator/raft/join" and method in ("PUT", "POST"):
            addr = (body or {}).get("Addr", "")
            if not addr:
                raise HTTPError(400, "missing Addr")
            try:
                return {"Members": server.join_peer(addr)}
            except ValueError as exc:
                raise HTTPError(501, str(exc))
        if path == "/v1/operator/raft/remove-peer" and method in (
            "PUT", "POST"
        ):
            addr = (body or {}).get("Addr", "")
            if not addr:
                raise HTTPError(400, "missing Addr")
            try:
                return {"Members": server.remove_peer(addr)}
            except ValueError as exc:
                raise HTTPError(501, str(exc))

        if path == "/v1/status/leader" and method == "GET":
            rep = store.replicator
            return rep.leader_addr if rep is not None else self.agent.rpc_addr
        if path == "/v1/agent/members" and method == "GET":
            members = [self.agent.member_info()]
            rep = store.replicator
            if rep is not None:
                st = rep.stats()
                members[0]["Leader"] = rep.is_leader
                members[0]["RaftTerm"] = st["Term"]
                for addr, pst in st["Peers"].items():
                    members.append({
                        "Name": addr,
                        "Addr": addr,
                        "Server": True,
                        "Status": "alive" if pst["Healthy"] else "failed",
                        "Leader": addr == st["LeaderAddr"],
                        "LastError": pst["LastError"],
                    })
                return {"Members": members, "Leader": st["LeaderAddr"]}
            return {"Members": members}
        if path == "/v1/agent/self" and method == "GET":
            return self.agent.member_info()
        if path == "/v1/agent/profile" and method == "GET":
            # Thread stack dump — the pprof-goroutine analog
            # (command/agent/pprof/pprof.go) for a Python runtime.
            import traceback as _tb

            frames = sys._current_frames()
            out = {}
            for t in threading.enumerate():
                frame = frames.get(t.ident)
                out[t.name] = (
                    _tb.format_stack(frame) if frame is not None else []
                )
            return {"Threads": out, "Count": len(out)}

        # ---- search (nomad/search_endpoint.go: prefix matches across
        # contexts, truncated at 20 per context) ----
        if path == "/v1/search" and method in ("PUT", "POST"):
            prefix = (body or {}).get("Prefix", "")
            context = (body or {}).get("Context", "all")
            ns = (body or {}).get("Namespace", "default")
            # Per-context capability gating (search_endpoint.go
            # sufficientSearchPerms): namespace contexts need read-job on
            # the searched namespace, nodes need node:read; a token with
            # neither gets 403 rather than an empty sweep.
            ns_ok = node_ok = True
            if server.config.acl_enabled:
                acl = server.resolve_token(token)
                if acl is None:
                    raise HTTPError(403, "ACL token not found")
                from ..acl import CAP_READ_JOB

                ns_ok = acl.allow_namespace(ns, CAP_READ_JOB)
                node_ok = acl.allow_node("read")
                if not ns_ok and not node_ok:
                    raise HTTPError(403, "Permission denied (search)")
            matches: Dict[str, List[str]] = {}
            truncations: Dict[str, bool] = {}

            def collect(name: str, ids):
                hits = [i for i in ids if i.startswith(prefix)]
                matches[name] = sorted(hits)[:20]
                truncations[name] = len(hits) > 20

            if not ns_ok:
                context = "nodes"
            elif not node_ok and context == "all":
                pass  # nodes skipped below
            if context in ("all", "jobs"):
                collect("jobs", [
                    jid for (jns, jid) in store.jobs if jns == ns
                ])
            if context in ("all", "nodes") and node_ok:
                collect("nodes", list(store.nodes))
            if context in ("all", "allocs"):
                collect("allocs", [
                    a.id for a in store.allocs.values()
                    if a.namespace == ns
                ])
            if context in ("all", "evals"):
                collect("evals", [
                    e.id for e in store.evals.values()
                    if e.namespace == ns
                ])
            if context in ("all", "deployment"):
                collect("deployment", [
                    d.id for d in store.deployments.values()
                    if d.namespace == ns
                ])
            return {"Matches": matches, "Truncations": truncations}

        # ---- namespaces (nomad/namespace_endpoint.go) ----
        if path == "/v1/namespaces" and method == "GET":
            return sorted(store.namespaces.values(), key=lambda n: n["Name"])
        m = re.match(r"^/v1/namespace/([^/]+)$", path)
        if m:
            if method == "GET":
                ns_obj = store.namespaces.get(m.group(1))
                if ns_obj is None:
                    raise HTTPError(404, "namespace not found")
                return ns_obj
            if method in ("PUT", "POST"):
                self._require_management(server, token)
                store.upsert_namespace(
                    server.next_index(), m.group(1),
                    (body or {}).get("Description", ""),
                )
                return {}
            if method == "DELETE":
                self._require_management(server, token)
                try:
                    store.delete_namespace(server.next_index(), m.group(1))
                except ValueError as exc:
                    raise HTTPError(400, str(exc))
                return {}

        if path == "/v1/operator/scheduler/configuration":
            if method == "GET":
                return _dump(store.scheduler_config)
            if method in ("PUT", "POST"):
                cfg = store.scheduler_config
                new = SchedulerConfiguration(
                    scheduler_algorithm=(body or {}).get(
                        "scheduler_algorithm", cfg.scheduler_algorithm
                    ),
                    preemption_config=cfg.preemption_config,
                    memory_oversubscription_enabled=(body or {}).get(
                        "memory_oversubscription_enabled",
                        cfg.memory_oversubscription_enabled,
                    ),
                )
                pc = (body or {}).get("preemption_config")
                if pc:
                    new.preemption_config = dataclasses.replace(
                        cfg.preemption_config, **pc
                    )
                store.set_scheduler_config(server.next_index(), new)
                return {"Updated": True}

        if path == "/v1/slo" and method == "GET":
            server = self.agent.server
            if server is None:
                raise HTTPError(501, "agent is not running a server")
            return server.observatory.slo_report()

        if path == "/v1/health" and method == "GET":
            # Liveness + overload surface: status/score/pressure inputs
            # plus currently breached SLOs (obs/health.py).  Always 200 —
            # the status field is the verdict, so a degraded cluster
            # still serves its own diagnosis.
            server = self.agent.server
            if server is None:
                raise HTTPError(501, "agent is not running a server")
            return server.observatory.health_report()

        if path == "/v1/overload" and method == "GET":
            # The control loop's full decision surface: state machine,
            # pressure windows, hysteresis budget, and per-actuator
            # stats (obs/controller.py).
            server = self.agent.server
            if server is None:
                raise HTTPError(501, "agent is not running a server")
            return server.overload_controller.report()

        if path == "/v1/metrics" and method == "GET":
            snap = self.agent.metrics()
            if query.get("format") == "prometheus":
                from ..metrics import to_prometheus

                return RawResponse(
                    to_prometheus(snap).encode(),
                    "text/plain; version=0.0.4; charset=utf-8",
                )
            return snap

        if path == "/v1/trace" and method == "GET":
            from .. import trace as _trace

            limit = None
            if query.get("limit"):
                try:
                    limit = int(query["limit"])
                except ValueError:
                    raise HTTPError(400, "limit must be an integer")
            records = _trace.dump(limit=limit)
            if query.get("clear") in ("1", "true"):
                _trace.clear()
            if query.get("format") == "chrome":
                # Perfetto-loadable body, ready to save to a file
                # (`nomad trace dump` fetches this).
                return RawResponse(
                    json.dumps(_trace.chrome_trace(records)).encode(),
                    "application/json",
                )
            return {
                "records": records,
                "count": len(records),
                "config": _trace.config(),
            }

        if path == "/v1/trace/config":
            from .. import trace as _trace

            if method == "GET":
                return _trace.config()
            if method in ("PUT", "POST"):
                b = body or {}
                return _trace.configure(
                    enabled=b.get("enabled"),
                    sample=b.get("sample"),
                    ring=b.get("ring"),
                )

        raise HTTPError(404, f"no handler for {method} {path}")

    @staticmethod
    def _job_stub(job) -> Dict[str, Any]:
        return {
            "id": job.id,
            "name": job.name,
            "namespace": job.namespace,
            "type": job.type,
            "priority": job.priority,
            "status": job.status,
            "stop": job.stop,
            "version": job.version,
            "modify_index": job.modify_index,
        }

    @staticmethod
    def _node_stub(node) -> Dict[str, Any]:
        return {
            "id": node.id,
            "name": node.name,
            "datacenter": node.datacenter,
            "node_class": node.node_class,
            "status": node.status,
            "drain": node.drain,
            "scheduling_eligibility": node.scheduling_eligibility,
        }
