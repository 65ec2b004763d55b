"""HTTP API client — what the CLI and external users consume.

Reference: the ``api/`` Go client package (api/jobs.go etc.).

The client is a well-behaved citizen under overload: a ``429 Too Many
Requests`` from the server's admission gate is retried through the
shared :mod:`..retry` backoff, honoring the ``Retry-After`` hint the
gate computed from the token bucket's actual deficit.  Waiting is
``max(backoff, Retry-After)`` — decorrelated jitter on top of the
server's floor, so a flash crowd of clients does not re-synchronize
into a retry storm.  ``NOMAD_TPU_RETRY_429_ATTEMPTS=1`` disables
retrying (callers see the 429 immediately).
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from ..retry import Backoff, RetryPolicy, env_int


class APIError(Exception):
    def __init__(
        self, code: int, message: str,
        retry_after: Optional[float] = None,
    ):
        super().__init__(f"HTTP {code}: {message}")
        self.code = code
        self.retry_after = retry_after


def _rate_limit_policy() -> RetryPolicy:
    return RetryPolicy(
        base_delay=0.2,
        max_delay=10.0,
        max_attempts=env_int("NOMAD_TPU_RETRY_429_ATTEMPTS", 3),
    )


class APIClient:
    def __init__(
        self, address: str = "http://127.0.0.1:4646", token: str = "",
        retry_policy: Optional[RetryPolicy] = None,
    ):
        self.address = address.rstrip("/")
        self.token = token  # X-Nomad-Token (SecretID) on every request
        self.retry_policy = retry_policy or _rate_limit_policy()
        self.rate_limited = 0  # 429s seen (retried or not)

    def _call(
        self, method: str, path: str, body: Optional[Any] = None
    ) -> Any:
        backoff = Backoff(self.retry_policy)
        attempts = 0
        while True:
            try:
                return self._call_once(method, path, body)
            except APIError as exc:
                if exc.code != 429:
                    raise
                self.rate_limited += 1
                attempts += 1
                cap = self.retry_policy.max_attempts or 1
                if attempts >= cap:
                    raise
                # Server's floor wins over our jittered backoff — never
                # retry before the gate says the bucket refills.
                delay = backoff.next_delay()
                if exc.retry_after is not None:
                    delay = max(delay, exc.retry_after)
                time.sleep(delay)

    def _call_once(
        self, method: str, path: str, body: Optional[Any] = None
    ) -> Any:
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Nomad-Token"] = self.token
        req = urllib.request.Request(
            f"{self.address}{path}", data=data, method=method,
            headers=headers,
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as exc:
            try:
                msg = json.loads(exc.read()).get("error", str(exc))
            except Exception:  # noqa: BLE001
                msg = str(exc)
            retry_after = None
            ra = exc.headers.get("Retry-After") if exc.headers else None
            if ra is not None:
                try:
                    retry_after = float(ra)
                except ValueError:
                    pass
            raise APIError(exc.code, msg, retry_after=retry_after) from exc

    # Jobs ------------------------------------------------------------

    def register_job(self, job_payload: Dict) -> Dict:
        return self._call("PUT", "/v1/jobs", {"Job": job_payload})

    def plan_job(
        self, job_id: str, job_payload: Dict, diff: bool = False,
        namespace: str = "default",
    ) -> Dict:
        return self._call(
            "PUT",
            f"/v1/job/{job_id}/plan?namespace={namespace}",
            {"Job": job_payload, "Diff": diff},
        )

    def list_jobs(self, prefix: str = "") -> List[Dict]:
        return self._call("GET", f"/v1/jobs?prefix={prefix}")

    # ACL --------------------------------------------------------------

    def acl_bootstrap(self) -> Dict:
        return self._call("POST", "/v1/acl/bootstrap")

    def acl_upsert_policy(
        self, name: str, rules: str, description: str = ""
    ) -> Dict:
        return self._call(
            "PUT", f"/v1/acl/policy/{name}",
            {"Rules": rules, "Description": description},
        )

    def acl_create_token(
        self, name: str = "", type: str = "client",
        policies: Optional[List[str]] = None,
    ) -> Dict:
        return self._call("POST", "/v1/acl/token", {
            "Name": name, "Type": type, "Policies": policies or [],
        })

    def acl_token_self(self) -> Dict:
        return self._call("GET", "/v1/acl/token/self")

    # Namespaces + search ----------------------------------------------

    def list_namespaces(self) -> List[Dict]:
        return self._call("GET", "/v1/namespaces")

    def upsert_namespace(self, name: str, description: str = "") -> Dict:
        return self._call(
            "PUT", f"/v1/namespace/{name}", {"Description": description}
        )

    def delete_namespace(self, name: str) -> Dict:
        return self._call("DELETE", f"/v1/namespace/{name}")

    def search(
        self, prefix: str, context: str = "all", namespace: str = "default"
    ) -> Dict:
        return self._call("POST", "/v1/search", {
            "Prefix": prefix, "Context": context, "Namespace": namespace,
        })

    def get_job(self, job_id: str, namespace: str = "default") -> Dict:
        return self._call("GET", f"/v1/job/{job_id}?namespace={namespace}")

    def deregister_job(
        self, job_id: str, purge: bool = False, namespace: str = "default"
    ) -> Dict:
        return self._call(
            "DELETE",
            f"/v1/job/{job_id}?namespace={namespace}"
            f"&purge={'true' if purge else 'false'}",
        )

    def job_allocations(self, job_id: str, namespace: str = "default"):
        return self._call(
            "GET", f"/v1/job/{job_id}/allocations?namespace={namespace}"
        )

    def job_evaluations(self, job_id: str, namespace: str = "default"):
        return self._call(
            "GET", f"/v1/job/{job_id}/evaluations?namespace={namespace}"
        )

    def job_summary(self, job_id: str, namespace: str = "default"):
        return self._call(
            "GET", f"/v1/job/{job_id}/summary?namespace={namespace}"
        )

    def dispatch_job(
        self, job_id: str, payload: bytes = b"", meta: Optional[Dict] = None,
        namespace: str = "default",
    ) -> Dict:
        import base64

        return self._call(
            "PUT", f"/v1/job/{job_id}/dispatch?namespace={namespace}",
            {
                "Payload": base64.b64encode(payload).decode()
                if payload else "",
                "Meta": meta or {},
            },
        )

    def job_versions(self, job_id: str, namespace: str = "default") -> Dict:
        return self._call(
            "GET", f"/v1/job/{job_id}/versions?namespace={namespace}"
        )

    def revert_job(
        self, job_id: str, version: Optional[int] = None,
        namespace: str = "default",
    ) -> Dict:
        body: Dict = {"Namespace": namespace}
        if version is not None:
            body["JobVersion"] = version
        return self._call("PUT", f"/v1/job/{job_id}/revert", body)

    def scale_job(
        self, job_id: str, group: str, count: int, message: str = "",
        namespace: str = "default",
    ) -> Dict:
        return self._call(
            "PUT", f"/v1/job/{job_id}/scale",
            {
                "Namespace": namespace, "Count": count,
                "Target": {"Group": group}, "Message": message,
            },
        )

    def job_scale_status(
        self, job_id: str, namespace: str = "default"
    ) -> Dict:
        return self._call(
            "GET", f"/v1/job/{job_id}/scale?namespace={namespace}"
        )

    def job_deployments(self, job_id: str, namespace: str = "default"):
        return self._call(
            "GET", f"/v1/job/{job_id}/deployments?namespace={namespace}"
        )

    # Deployments ------------------------------------------------------

    def list_deployments(self, namespace: str = "default") -> List[Dict]:
        return self._call("GET", f"/v1/deployments?namespace={namespace}")

    def get_deployment(self, deployment_id: str) -> Dict:
        return self._call("GET", f"/v1/deployment/{deployment_id}")

    def deployment_allocations(self, deployment_id: str) -> List[Dict]:
        return self._call(
            "GET", f"/v1/deployment/{deployment_id}/allocations"
        )

    def promote_deployment(
        self, deployment_id: str, groups: Optional[List[str]] = None
    ) -> Dict:
        body: Dict = {"All": True} if not groups else {"Groups": groups}
        return self._call(
            "PUT", f"/v1/deployment/{deployment_id}/promote", body
        )

    def fail_deployment(self, deployment_id: str) -> Dict:
        return self._call("PUT", f"/v1/deployment/{deployment_id}/fail", {})

    def pause_deployment(self, deployment_id: str, pause: bool = True) -> Dict:
        return self._call(
            "PUT", f"/v1/deployment/{deployment_id}/pause", {"Pause": pause}
        )

    # System -----------------------------------------------------------

    def system_gc(self) -> Dict:
        return self._call("PUT", "/v1/system/gc", {})

    def alloc_exec(
        self, alloc_id: str, task: str, argv: List[str],
        stdin: bytes = b"", timeout: float = 300.0,
    ):
        """Run a command in a task's context; returns (exit_code, stdout,
        stderr).  Streams NDJSON frames from /v1/client/exec/."""
        import base64
        import urllib.request

        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Nomad-Token"] = self.token
        req = urllib.request.Request(
            f"{self.address}/v1/client/exec/{alloc_id}",
            data=json.dumps({
                "Task": task,
                "Cmd": list(argv),
                "Stdin": base64.b64encode(stdin).decode() if stdin else "",
                "Timeout": timeout,
            }).encode(),
            method="POST",
            headers=headers,
        )
        out, err, code = b"", b"", -1
        try:
            with urllib.request.urlopen(req, timeout=timeout + 30) as resp:
                for line in resp:
                    if not line.strip():
                        continue
                    frame = json.loads(line)
                    if "stdout" in frame:
                        out += base64.b64decode(frame["stdout"])
                    if "stderr" in frame:
                        err += base64.b64decode(frame["stderr"])
                    if "error" in frame:
                        raise APIError(500, frame["error"])
                    if "exit" in frame:
                        code = int(frame["exit"])
        except urllib.error.HTTPError as exc:
            try:
                msg = json.loads(exc.read()).get("error", str(exc))
            except Exception:  # noqa: BLE001
                msg = str(exc)
            raise APIError(exc.code, msg) from exc
        return code, out, err

    # Volumes ----------------------------------------------------------

    def list_volumes(self, namespace: str = "default") -> List[Dict]:
        return self._call("GET", f"/v1/volumes?namespace={namespace}")

    def register_volume(self, spec: Dict, namespace: str = "default") -> Dict:
        return self._call(
            "PUT", f"/v1/volumes?namespace={namespace}", {"Volume": spec}
        )

    def get_volume(self, volume_id: str, namespace: str = "default") -> Dict:
        return self._call(
            "GET", f"/v1/volume/{volume_id}?namespace={namespace}"
        )

    def deregister_volume(
        self, volume_id: str, namespace: str = "default"
    ) -> Dict:
        return self._call(
            "DELETE", f"/v1/volume/{volume_id}?namespace={namespace}"
        )

    def server_join(self, addr: str) -> Dict:
        return self._call("PUT", "/v1/operator/raft/join", {"Addr": addr})

    def server_remove_peer(self, addr: str) -> Dict:
        return self._call(
            "PUT", "/v1/operator/raft/remove-peer", {"Addr": addr}
        )

    def list_scaling_policies(self, namespace: str = "default"):
        return self._call(
            "GET", f"/v1/scaling/policies?namespace={namespace}"
        )

    def validate_job(self, job_payload: Dict) -> Dict:
        return self._call("PUT", "/v1/validate/job", {"Job": job_payload})

    def list_evaluations(self, namespace: str = "default") -> List[Dict]:
        return self._call("GET", f"/v1/evaluations?namespace={namespace}")

    def parse_job_hcl(self, hcl: str) -> Dict:
        return self._call("POST", "/v1/jobs/parse", {"JobHCL": hcl})

    # Nodes -----------------------------------------------------------

    def list_nodes(self) -> List[Dict]:
        return self._call("GET", "/v1/nodes")

    def get_node(self, node_id: str) -> Dict:
        return self._call("GET", f"/v1/node/{node_id}")

    def node_allocations(self, node_id: str):
        return self._call("GET", f"/v1/node/{node_id}/allocations")

    def drain_node(
        self, node_id: str, enable: bool = True, deadline: float = 3600.0
    ) -> Dict:
        body = {"DrainSpec": {"Deadline": deadline}} if enable else {
            "DrainSpec": None, "MarkEligible": True,
        }
        return self._call("PUT", f"/v1/node/{node_id}/drain", body)

    def set_node_eligibility(self, node_id: str, eligible: bool) -> Dict:
        return self._call(
            "PUT",
            f"/v1/node/{node_id}/eligibility",
            {"Eligibility": "eligible" if eligible else "ineligible"},
        )

    # Evals / allocs ----------------------------------------------------

    def get_evaluation(self, eval_id: str) -> Dict:
        return self._call("GET", f"/v1/evaluation/{eval_id}")

    def get_allocation(self, alloc_id: str) -> Dict:
        return self._call("GET", f"/v1/allocation/{alloc_id}")

    def restart_allocation(self, alloc_id: str, task: str = "") -> Dict:
        return self._call(
            "POST", f"/v1/client/allocation/{alloc_id}/restart",
            {"Task": task},
        )

    def signal_allocation(
        self, alloc_id: str, signal: str = "SIGTERM", task: str = ""
    ) -> Dict:
        return self._call(
            "POST", f"/v1/client/allocation/{alloc_id}/signal",
            {"Signal": signal, "Task": task},
        )

    def stop_allocation(self, alloc_id: str) -> Dict:
        return self._call("PUT", f"/v1/allocation/{alloc_id}/stop")

    # Operator / agent --------------------------------------------------

    def members(self) -> Dict:
        return self._call("GET", "/v1/agent/members")

    def leader(self) -> str:
        return self._call("GET", "/v1/status/leader")

    def scheduler_configuration(self) -> Dict:
        return self._call("GET", "/v1/operator/scheduler/configuration")

    def set_scheduler_configuration(self, config: Dict) -> Dict:
        return self._call(
            "PUT", "/v1/operator/scheduler/configuration", config
        )

    def metrics(self) -> Dict:
        return self._call("GET", "/v1/metrics")

    def metrics_prometheus(self) -> str:
        """Prometheus text exposition of the agent's metrics registry."""
        return self._call_raw("GET", "/v1/metrics?format=prometheus").decode()

    def slo(self) -> Dict:
        """SLO observatory report: per-spec value, burn rates, status."""
        return self._call("GET", "/v1/slo")

    def health(self) -> Dict:
        """Composite health: status band, score, pressure inputs."""
        return self._call("GET", "/v1/health")

    def overload(self) -> Dict:
        """Overload controller report: state machine, pressure windows,
        flip budget, per-actuator stats (obs/controller.py)."""
        return self._call("GET", "/v1/overload")

    # Tracing -----------------------------------------------------------

    def trace_records(
        self, limit: Optional[int] = None, clear: bool = False
    ) -> Dict:
        qs = []
        if limit is not None:
            qs.append(f"limit={limit}")
        if clear:
            qs.append("clear=1")
        suffix = "?" + "&".join(qs) if qs else ""
        return self._call("GET", f"/v1/trace{suffix}")

    def trace_dump(self, limit: Optional[int] = None) -> bytes:
        """Chrome trace-event JSON body (Perfetto-loadable), as bytes."""
        suffix = "&limit=%d" % limit if limit is not None else ""
        return self._call_raw("GET", f"/v1/trace?format=chrome{suffix}")

    def trace_config(self) -> Dict:
        return self._call("GET", "/v1/trace/config")

    def trace_configure(self, **kwargs) -> Dict:
        return self._call("PUT", "/v1/trace/config", kwargs)

    def _call_raw(self, method: str, path: str) -> bytes:
        headers = {}
        if self.token:
            headers["X-Nomad-Token"] = self.token
        req = urllib.request.Request(
            f"{self.address}{path}", method=method, headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=30) as resp:
                return resp.read()
        except urllib.error.HTTPError as exc:
            try:
                msg = json.loads(exc.read()).get("error", str(exc))
            except Exception:  # noqa: BLE001
                msg = str(exc)
            raise APIError(exc.code, msg) from exc
