"""Task drivers — the pluggable execution boundary.

Reference: the driver plugin protocol (``plugins/drivers/driver.go:47-65``):
Fingerprint, StartTask, WaitTask, StopTask, DestroyTask, RecoverTask,
InspectTask. The reference isolates drivers behind a gRPC process boundary
(go-plugin); here the protocol is the same Python interface, with the C++
executor slotting underneath the exec driver (SURVEY.md §2.4 mapping).

Two built-ins:

- ``MockDriver`` — fully scriptable fake (reference: ``drivers/mock/``,
  the cornerstone of client/integration testing): start errors, run_for,
  exit codes, kill_after, start_block_for.
- ``RawExecDriver`` — un-isolated subprocess execution (reference:
  ``drivers/rawexec/``).

A copy of the reference package's ``client/driver.py``, its chaos seams
included (``driver.start``/``driver.wait``/``driver.stop`` through
:func:`_chaos`, with their trace events).  The exec driver's
Python sidecar is this package's own, ``nomad_tpu_torch.client.executor``.
Every process is started with ``subprocess.Popen`` (fork and exec), so a
driver is safe in a process that holds a CUDA context.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from .. import trace
from ..chaos import inject
from ..retry import RetryBudgetExceeded, RetryPolicy, retry_call
from ..structs.types import Task


@dataclass
class ExitResult:
    exit_code: int = 0
    signal: int = 0
    err: str = ""
    oom_killed: bool = False

    def successful(self) -> bool:
        return self.exit_code == 0 and self.signal == 0 and not self.err


@dataclass
class TaskHandle:
    """Opaque, re-attachable handle to a running task (reference:
    drivers.TaskHandle — persisted so RecoverTask can re-attach after an
    agent restart)."""

    id: str
    driver: str
    task_name: str
    alloc_id: str
    config: Dict[str, Any] = field(default_factory=dict)
    pid: int = 0
    started_at: float = 0.0


class DriverError(Exception):
    pass


def _chaos(point: str, driver: str, task: str):
    """Driver-seam chaos hook.  "hang" (a wedged runtime syscall) is
    absorbed here as a sleep; "error" raises; anything else — "exit127"
    at start, "wedge" at wait, "skip" at stop — is returned for the
    caller to act on, since only it can fabricate the right outcome."""
    fault = inject(point, driver=driver, task=task)
    trace.event("seam." + point, driver=driver, task=task)
    if fault is None:
        return None
    if fault.kind == "hang":
        time.sleep(fault.duration or 1.0)
        return None
    if fault.kind == "error":
        raise DriverError(f"injected {point} failure")
    return fault


class Driver:
    """Base driver interface."""

    name = "driver"

    def fingerprint(self) -> Dict[str, str]:
        """Attributes to merge into the node (driver.X detected/healthy)."""
        return {f"driver.{self.name}": "1"}

    def start_task(self, handle: TaskHandle, task: Task, task_dir: str) -> None:
        raise NotImplementedError

    def wait_task(self, handle: TaskHandle, timeout: Optional[float] = None) -> Optional[ExitResult]:
        raise NotImplementedError

    def stop_task(self, handle: TaskHandle, kill_timeout: float) -> None:
        raise NotImplementedError

    def destroy_task(self, handle: TaskHandle) -> None:
        pass

    def recover_task(self, handle: TaskHandle) -> bool:
        """Re-attach to a still-running task after agent restart
        (driver.go:54). Returns False when the task is gone."""
        return False

    def inspect_task(self, handle: TaskHandle) -> str:
        return "unknown"

    def signal_task(self, handle: TaskHandle, sig: int) -> None:
        """Deliver a signal to the running task (Driver.SignalTask,
        plugins/drivers/driver.go)."""
        raise DriverError(f"{self.name} driver does not support signals")

    def stats_task(self, handle: TaskHandle) -> Dict[str, Any]:
        """Point-in-time resource usage (TaskStats; the reference streams
        these, plugins/drivers driver.proto).  Empty dict = unsupported."""
        return {}


class _MockInstance:
    def __init__(self):
        self.done = threading.Event()
        self.result: Optional[ExitResult] = None
        self.timer: Optional[threading.Timer] = None


class MockDriver(Driver):
    """Scriptable fake driver. Task ``config`` knobs (reference:
    drivers/mock/driver.go:74-80):

    - ``start_error``: error message raised from start_task
    - ``start_error_recoverable``: marks the error recoverable
    - ``start_block_for``: seconds start_task blocks before returning
    - ``run_for``: seconds the task runs before exiting
    - ``exit_code`` / ``exit_signal`` / ``exit_err_msg``
    - ``kill_after``: seconds to keep running after a stop request
    """

    name = "mock"

    def __init__(self):
        self._instances: Dict[str, _MockInstance] = {}
        self._lock = threading.Lock()

    def start_task(self, handle: TaskHandle, task: Task, task_dir: str) -> None:
        cfg = task.config or {}
        fault = _chaos("driver.start", self.name, task.name)
        if fault is not None and fault.kind == "exit127":
            # Command-not-found at exec time: starts "successfully", then
            # the child exits 127 immediately.
            cfg = dict(cfg, run_for=0, exit_code=127)
        if cfg.get("start_error"):
            raise DriverError(str(cfg["start_error"]))
        block = float(cfg.get("start_block_for", 0))
        if block:
            time.sleep(block)
        inst = _MockInstance()
        with self._lock:
            self._instances[handle.id] = inst
        run_for = float(cfg.get("run_for", 0))
        result = ExitResult(
            exit_code=int(cfg.get("exit_code", 0)),
            signal=int(cfg.get("exit_signal", 0)),
            err=str(cfg.get("exit_err_msg", "")),
        )

        def finish():
            inst.result = result
            inst.done.set()

        if run_for > 0:
            inst.timer = threading.Timer(run_for, finish)
            inst.timer.daemon = True
            inst.timer.start()
        elif run_for == 0 and "run_for" in cfg:
            finish()  # exits immediately
        # run_for unset -> runs until stopped
        handle.pid = os.getpid()
        handle.started_at = time.time()
        handle.config = dict(cfg)

    def wait_task(self, handle: TaskHandle, timeout: Optional[float] = None):
        fault = _chaos("driver.wait", self.name, handle.task_name)
        if fault is not None and fault.kind == "wedge":
            # Wedged driver: never reports the exit, only "still running".
            if timeout:
                time.sleep(min(timeout, 0.05))
            return None
        inst = self._instances.get(handle.id)
        if inst is None:
            return ExitResult(err="unknown task")
        if not inst.done.wait(timeout=timeout):
            return None
        return inst.result

    def stop_task(self, handle: TaskHandle, kill_timeout: float) -> None:
        fault = _chaos("driver.stop", self.name, handle.task_name)
        if fault is not None and fault.kind == "skip":
            return  # stop request swallowed by a wedged runtime
        inst = self._instances.get(handle.id)
        if inst is None:
            return
        kill_after = float(handle.config.get("kill_after", 0))
        delay = min(kill_after, kill_timeout) if kill_after else 0.0

        def finish():
            inst.result = ExitResult(exit_code=0, signal=9)
            inst.done.set()

        if delay > 0:
            t = threading.Timer(delay, finish)
            t.daemon = True
            t.start()
        else:
            finish()

    def destroy_task(self, handle: TaskHandle) -> None:
        with self._lock:
            inst = self._instances.pop(handle.id, None)
        if inst and inst.timer:
            inst.timer.cancel()

    def recover_task(self, handle: TaskHandle) -> bool:
        # In-process driver: instances die with the agent, like a container
        # runtime losing its containers on host reboot.
        return handle.id in self._instances

    def inspect_task(self, handle: TaskHandle) -> str:
        inst = self._instances.get(handle.id)
        if inst is None:
            return "unknown"
        return "exited" if inst.done.is_set() else "running"

    def signal_task(self, handle: TaskHandle, sig: int) -> None:
        handle.config.setdefault("signals_received", []).append(int(sig))


class RawExecDriver(Driver):
    """Un-isolated subprocess execution (reference: drivers/rawexec/).

    Task config: ``command`` (required), ``args`` (list). The C++ executor
    supervisor (``native/``) slots under this same interface.
    """

    name = "raw_exec"

    def __init__(self):
        self._procs: Dict[str, subprocess.Popen] = {}
        self._lock = threading.Lock()

    def start_task(self, handle: TaskHandle, task: Task, task_dir: str) -> None:
        cfg = task.config or {}
        command = cfg.get("command")
        if not command:
            raise DriverError("raw_exec requires config.command")
        args = [str(command)] + [str(a) for a in cfg.get("args", [])]
        fault = _chaos("driver.start", self.name, task.name)
        if fault is not None and fault.kind == "exit127":
            args = ["/bin/sh", "-c", "exit 127"]  # command-not-found
        stdout = stderr = None
        try:
            stdout = open(os.path.join(task_dir, f"{task.name}.stdout"), "ab")
            stderr = open(os.path.join(task_dir, f"{task.name}.stderr"), "ab")
        except OSError as exc:
            # The alloc dir can vanish mid-restart (destroy racing the
            # restart loop) — a start failure, not an agent crash.
            if stdout is not None:
                stdout.close()
            raise DriverError(f"task dir unavailable: {exc}") from exc
        env = dict(os.environ)
        env.update({k: str(v) for k, v in (task.env or {}).items()})
        try:
            proc = subprocess.Popen(
                args, cwd=task_dir, stdout=stdout, stderr=stderr, env=env,
                start_new_session=True,
            )
        except OSError as exc:
            raise DriverError(str(exc)) from exc
        finally:
            stdout.close()
            stderr.close()
        with self._lock:
            self._procs[handle.id] = proc
        handle.pid = proc.pid
        handle.started_at = time.time()

    def wait_task(self, handle: TaskHandle, timeout: Optional[float] = None):
        fault = _chaos("driver.wait", self.name, handle.task_name)
        if fault is not None and fault.kind == "wedge":
            if timeout:
                time.sleep(min(timeout, 0.05))
            return None
        proc = self._procs.get(handle.id)
        if proc is None:
            return ExitResult(err="unknown task")
        try:
            code = proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        if code < 0:
            return ExitResult(exit_code=0, signal=-code)
        return ExitResult(exit_code=code)

    def stop_task(self, handle: TaskHandle, kill_timeout: float) -> None:
        proc = self._procs.get(handle.id)
        if proc is None or proc.poll() is not None:
            return
        try:
            os.killpg(proc.pid, signal.SIGTERM)
        except (ProcessLookupError, PermissionError):
            return

        def hard_kill():
            if proc.poll() is None:
                try:
                    os.killpg(proc.pid, signal.SIGKILL)
                except (ProcessLookupError, PermissionError):
                    pass

        t = threading.Timer(kill_timeout, hard_kill)
        t.daemon = True
        t.start()

    def destroy_task(self, handle: TaskHandle) -> None:
        proc = self._procs.pop(handle.id, None)
        if proc is not None and proc.poll() is None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass

    def signal_task(self, handle: TaskHandle, sig: int) -> None:
        proc = self._procs.get(handle.id)
        pid = proc.pid if proc is not None else handle.pid
        if not pid:
            raise DriverError("task has no pid")
        try:
            os.killpg(pid, sig)
        except (ProcessLookupError, PermissionError):
            try:
                os.kill(pid, sig)
            except OSError as exc:
                raise DriverError(str(exc)) from exc

    def stats_task(self, handle: TaskHandle) -> Dict[str, Any]:
        from .executor import _group_usage

        proc = self._procs.get(handle.id)
        pid = proc.pid if proc is not None else handle.pid
        if not pid:
            return {}
        rss, ticks = _group_usage(pid)
        return {"rss_bytes": rss, "cpu_ticks": ticks, "pid": pid}

    def recover_task(self, handle: TaskHandle) -> bool:
        """Re-attach after an agent restart: the task process is no longer
        our child (we cannot waitpid it), so supervision resumes through a
        kill-0 polling shim — the same technique the reference's executor
        uses for its pre-0.9 recovery shims (drivers/shared/executor)."""
        if handle.id in self._procs:
            return True
        if handle.pid:
            try:
                os.kill(handle.pid, 0)
            except (ProcessLookupError, PermissionError):
                return False
            with self._lock:
                self._procs[handle.id] = _ReattachedProc(handle.pid)
            return True
        return False

    def inspect_task(self, handle: TaskHandle) -> str:
        proc = self._procs.get(handle.id)
        if proc is None:
            return "unknown"
        return "running" if proc.poll() is None else "exited"


class _ReattachedProc:
    """Popen-shaped supervision of a non-child process (recovery path).

    The exit *status* of a non-child is unobservable; disappearance is
    reported as exit 0 with a marker in ``err`` left to the caller.
    """

    def __init__(self, pid: int):
        self.pid = pid
        self._code: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self._code is not None:
            return self._code
        try:
            os.kill(self.pid, 0)
            return None
        except (ProcessLookupError, PermissionError):
            self._code = 0  # status unobservable for a non-child
            return self._code

    def wait(self, timeout: Optional[float] = None) -> int:
        deadline = None if timeout is None else time.time() + timeout
        while True:
            code = self.poll()
            if code is not None:
                return code
            if deadline is not None and time.time() >= deadline:
                raise subprocess.TimeoutExpired(f"pid {self.pid}", timeout)
            time.sleep(0.05)


class SidecarClient:
    """Handle to one executor sidecar process (client/executor.py).

    The go-plugin analog: spawn a detached supervisor subprocess, talk
    JSON-lines over its unix socket, and — when the sidecar is found dead
    — spawn a replacement and hand it the dead one's task table to
    recover by pid (reattach-config semantics)."""

    def __init__(self, state_dir: str, binary: Optional[str] = None):
        self.state_dir = state_dir
        self.sock_path = os.path.join(state_dir, "executor.sock")
        self.state_path = os.path.join(state_dir, "executor.state.json")
        # Explicit supervisor binary (external driver plugins); None =
        # auto (native/nomad-executor when built, Python fallback).
        self.binary = binary
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None

    # -- wire -----------------------------------------------------------

    def _call_raw(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        import socket as _socket

        with _socket.socket(_socket.AF_UNIX) as s:
            s.settimeout(30.0)
            s.connect(self.sock_path)
            s.sendall((json.dumps(payload) + "\n").encode())
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = s.recv(65536)
                if not chunk:
                    break
                buf += chunk
        out = json.loads(buf)
        if out.get("error"):
            raise DriverError(out["error"])
        return out

    def call(self, op: str, **kw) -> Dict[str, Any]:
        """One sidecar op; a dead sidecar is replaced (and its tasks
        recovered) transparently — EXCEPT for ``start``, which is not
        idempotent: a lost start response retried against a respawned
        sidecar could launch the task twice (the first copy running
        unsupervised).  Start failures surface to the restart policy."""
        kw["op"] = op
        with self._lock:
            try:
                return self._call_raw(kw)
            except (OSError, ValueError) as exc:
                if op == "start":
                    raise DriverError(
                        f"sidecar start failed/indeterminate: {exc}"
                    ) from exc
                self._respawn_locked()
                return self._call_raw(kw)

    def ensure_running(self) -> None:
        with self._lock:
            try:
                self._call_raw({"op": "ping"})
            except (OSError, ValueError):
                self._respawn_locked()

    def _respawn_locked(self) -> None:
        # Read the DEAD sidecar's task table BEFORE the replacement
        # truncates the state file.
        orphans: Dict[str, Dict[str, Any]] = {}
        try:
            with open(self.state_path) as fh:
                orphans = (json.loads(fh.read()) or {}).get("tasks", {})
        except (OSError, ValueError):
            pass
        os.makedirs(self.state_dir, exist_ok=True)
        import sys

        # The native C++ supervisor (native/executor.cc) speaks the same
        # protocol and is preferred when built; the Python sidecar is the
        # always-available fallback.  NOMAD_TPU_EXECUTOR_BIN overrides
        # (empty string forces Python).  This package runs the binary as it
        # finds it and never builds it; its Python sidecar is its own
        # module, which imports neither torch nor CUDA.
        native = (
            self.binary if self.binary is not None
            else os.environ.get("NOMAD_TPU_EXECUTOR_BIN")
        )
        if native is None:
            candidate = os.path.join(
                os.path.dirname(os.path.dirname(
                    os.path.dirname(os.path.abspath(__file__))
                )),
                "native", "nomad-executor",
            )
            native = candidate if os.access(candidate, os.X_OK) else ""
        env = None
        if native:
            cmd = [native, "--socket", self.sock_path,
                   "--state-dir", self.state_dir]
        else:
            cmd = [sys.executable, "-m", "nomad_tpu_torch.client.executor",
                   "--socket", self.sock_path,
                   "--state-dir", self.state_dir]
            # The sidecar imports this package from where the agent does,
            # whatever the working directory (the reference relies on it
            # being the repository root).
            root = os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__))))
            env = dict(os.environ)
            env["PYTHONPATH"] = os.pathsep.join(
                p for p in (root, env.get("PYTHONPATH", "")) if p)
        self._proc = subprocess.Popen(
            cmd,
            env=env,
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            start_new_session=True,  # survives the agent
        )
        try:
            retry_call(
                lambda: self._call_raw({"op": "ping"}),
                policy=RetryPolicy(
                    base_delay=0.05, max_delay=0.5, deadline=15.0
                ),
                retry_on=(OSError, ValueError),
                description="executor sidecar boot ping",
            )
        except RetryBudgetExceeded as exc:
            raise DriverError(
                f"executor sidecar failed to start: {exc.__cause__}"
            ) from exc
        # Recover the orphaned (setsid'd, still-running) tasks by pid.
        for tid, info in orphans.items():
            try:
                self._call_raw({
                    "op": "recover", "id": tid,
                    "pid": info["pid"], "start_ts": info.get("start_ts", 0),
                })
            except (OSError, ValueError, DriverError):
                pass

    def shutdown(self) -> None:
        try:
            with self._lock:
                self._call_raw({"op": "shutdown"})
        except (OSError, ValueError):
            pass


class ExecDriver(Driver):
    """Isolated subprocess execution through the executor sidecar
    (reference: drivers/exec/ over drivers/shared/executor/ — trimmed to
    the no-privilege isolations: setsid, rlimits, best-effort cgroup v2).

    Task config: ``command`` (required), ``args``, ``rlimits`` (map of
    cpu/nofile/as/fsize/nproc → soft+hard value), ``cgroup`` (bool).
    """

    name = "exec"
    # Subdir of the client data dir holding this driver's sidecar state;
    # None binary = auto-select (native build, Python fallback).
    sidecar_subdir = "executor"
    binary: Optional[str] = None

    def __init__(self, state_dir: str = ""):
        self._state_dir = state_dir
        self._sidecar: Optional[SidecarClient] = None
        self._lock = threading.Lock()

    def _get_sidecar(self, state_dir: str = "") -> SidecarClient:
        with self._lock:
            if self._sidecar is None:
                sd = self._state_dir or state_dir
                if not sd:
                    raise DriverError(
                        f"{self.name} driver has no state dir yet"
                    )
                self._state_dir = sd
                self._sidecar = SidecarClient(
                    os.path.join(sd, self.sidecar_subdir),
                    binary=self.binary,
                )
                self._sidecar.ensure_running()
            return self._sidecar

    def start_task(self, handle: TaskHandle, task: Task, task_dir: str) -> None:
        cfg = task.config or {}
        command = cfg.get("command")
        if not command:
            raise DriverError("exec requires config.command")
        # The sidecar outlives agent restarts; the handle carries the
        # state dir so recover_task can find it again.
        state_dir = os.path.dirname(os.path.dirname(task_dir))
        handle.config = {"state_dir": state_dir}
        sidecar = self._get_sidecar(state_dir)
        # Preflight: a dead sidecar respawns HERE (idempotent ping), so
        # the non-retryable start below runs against a live one.
        sidecar.ensure_running()
        env = dict(os.environ)
        env.update({k: str(v) for k, v in (task.env or {}).items()})
        argv = [str(command)] + [str(a) for a in cfg.get("args", [])]
        fault = _chaos("driver.start", self.name, task.name)
        if fault is not None and fault.kind == "exit127":
            argv = ["/bin/sh", "-c", "exit 127"]  # command-not-found
        try:
            out = sidecar.call(
                "start",
                id=handle.id,
                argv=argv,
                cwd=task_dir,
                env=env,
                stdout=os.path.join(task_dir, f"{task.name}.stdout"),
                stderr=os.path.join(task_dir, f"{task.name}.stderr"),
                rlimits=cfg.get("rlimits") or {},
                cgroup=bool(cfg.get("cgroup", True)),
            )
        except DriverError:
            raise
        except OSError as exc:
            raise DriverError(f"sidecar unavailable: {exc}") from exc
        handle.pid = int(out["pid"])
        handle.started_at = float(out["start_ts"])

    def wait_task(self, handle: TaskHandle, timeout: Optional[float] = None):
        fault = _chaos("driver.wait", self.name, handle.task_name)
        if fault is not None and fault.kind == "wedge":
            if timeout:
                time.sleep(min(timeout, 0.05))
            return None
        sidecar = self._get_sidecar(handle.config.get("state_dir", ""))
        deadline = None if timeout is None else time.time() + timeout
        while True:
            try:
                out = sidecar.call("wait", id=handle.id)
            except (DriverError, OSError) as exc:
                return ExitResult(err=f"sidecar lost task: {exc}")
            if not out.get("running"):
                return ExitResult(
                    exit_code=int(out.get("exit_code", 0)),
                    signal=int(out.get("signal", 0)),
                )
            if deadline is not None and time.time() >= deadline:
                return None
            time.sleep(0.05)

    def stop_task(self, handle: TaskHandle, kill_timeout: float) -> None:
        try:
            self._get_sidecar(handle.config.get("state_dir", "")).call(
                "stop", id=handle.id, grace=kill_timeout
            )
        except (DriverError, OSError):
            pass

    def destroy_task(self, handle: TaskHandle) -> None:
        try:
            self._get_sidecar(handle.config.get("state_dir", "")).call(
                "destroy", id=handle.id
            )
        except (DriverError, OSError):
            pass

    def recover_task(self, handle: TaskHandle) -> bool:
        """Agent restart: the sidecar (and the task) kept running.  If the
        sidecar still supervises the task, done; if the sidecar died too,
        the respawn path re-adopts the task by pid."""
        state_dir = handle.config.get("state_dir", "")
        if not state_dir:
            return False
        try:
            sidecar = self._get_sidecar(state_dir)
            out = sidecar.call("list")
            info = out.get("tasks", {}).get(handle.id)
            if info is not None:
                return bool(info.get("running"))
            if handle.pid and os.path.exists(f"/proc/{handle.pid}"):
                got = sidecar.call(
                    "recover", id=handle.id, pid=handle.pid,
                    start_ts=handle.started_at,
                )
                return bool(got.get("ok"))
        except (DriverError, OSError):
            return False
        return False

    def inspect_task(self, handle: TaskHandle) -> str:
        try:
            out = self._get_sidecar(
                handle.config.get("state_dir", "")
            ).call("wait", id=handle.id)
            return "running" if out.get("running") else "exited"
        except (DriverError, OSError):
            return "unknown"

    def signal_task(self, handle: TaskHandle, sig: int) -> None:
        try:
            self._get_sidecar(handle.config.get("state_dir", "")).call(
                "signal", id=handle.id, signal=int(sig)
            )
        except OSError as exc:
            raise DriverError(str(exc)) from exc

    def stats_task(self, handle: TaskHandle) -> Dict[str, Any]:
        try:
            out = self._get_sidecar(
                handle.config.get("state_dir", "")
            ).call("stats", id=handle.id)
        except (DriverError, OSError):
            return {}
        return {
            k: out[k] for k in ("rss_bytes", "cpu_ticks", "pid")
            if k in out
        }

    def shutdown(self) -> None:
        with self._lock:
            if self._sidecar is not None:
                self._sidecar.shutdown()
                self._sidecar = None


class ExternalPluginDriver(ExecDriver):
    """An operator-supplied task driver running as its OWN supervisor
    process — the go-plugin dispense analog (plugins/base/proto +
    plugins/drivers/proto): the agent spawns the configured binary and
    speaks the executor JSON-lines protocol to it (start/wait/stop/
    destroy/recover/list, plus an optional ``info`` op for
    name/version/config-schema discovery).  ``native/executor.cc`` and
    ``client/executor.py`` double as reference plugin implementations.

    Plugin config (client ``plugin "name" { binary = ... }`` blocks):
    the binary must accept ``--socket PATH --state-dir DIR``.
    """

    def __init__(self, name: str, binary: str, state_dir: str = ""):
        super().__init__(state_dir)
        self.name = name
        self.binary = binary
        self.sidecar_subdir = f"plugin-{name}"
        self._info: Optional[Dict[str, Any]] = None

    def info(self, state_dir: str = "") -> Dict[str, Any]:
        """PluginInfo + ConfigSchema (plugins/base/proto/base.proto):
        optional — a plugin without the op reports bare detection.
        Transient spawn failures are NOT cached (retried next call)."""
        if self._info is None:
            try:
                self._info = self._get_sidecar(state_dir).call("info")
            except (DriverError, OSError):
                return {}
        return self._info

    def fingerprint(self) -> Dict[str, str]:
        """Called at client boot + every re-fingerprint pass — this is
        where the plugin is dispensed and its info discovered."""
        info = self.info()
        attrs = {f"driver.{self.name}": "1"}
        version = info.get("version")
        if version:
            attrs[f"driver.{self.name}.version"] = str(version)
        return attrs

    def start_task(self, handle: TaskHandle, task: Task, task_dir: str) -> None:
        # Schema-validate the task's config {} against what the plugin
        # declared (hclspec analog, trimmed to required-key checking).
        state_dir = os.path.dirname(os.path.dirname(task_dir))
        schema = self.info(state_dir).get("config_schema") or {}
        required = schema.get("required") or []
        missing = [k for k in required if k not in (task.config or {})]
        if missing:
            raise DriverError(
                f"plugin {self.name!r} requires config keys {missing}"
            )
        super().start_task(handle, task, task_dir)


class DriverRegistry:
    """Per-client driver instances (reference: client/pluginmanager/
    drivermanager — dispense + fingerprint)."""

    def __init__(self, drivers: Optional[Dict[str, Driver]] = None):
        self.drivers: Dict[str, Driver] = drivers or {
            "mock": MockDriver(),
            "raw_exec": RawExecDriver(),
            "exec": ExecDriver(),
        }

    def register_plugin(
        self, name: str, binary: str, state_dir: str = ""
    ) -> None:
        """Dispense an external driver plugin (drivermanager dispense)."""
        self.drivers[name] = ExternalPluginDriver(
            name, binary, state_dir=state_dir
        )

    def get(self, name: str) -> Driver:
        d = self.drivers.get(name)
        if d is None:
            raise DriverError(f"unknown driver {name!r}")
        return d

    def fingerprint(self) -> Dict[str, str]:
        attrs: Dict[str, str] = {}
        for d in self.drivers.values():
            attrs.update(d.fingerprint())
        return attrs

    def shutdown(self) -> None:
        for d in self.drivers.values():
            if hasattr(d, "shutdown"):
                d.shutdown()
