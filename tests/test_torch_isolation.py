"""The port stands alone: no JAX, no ``nomad_tpu``, no silent CPU fallback.

* a fresh interpreter that imports the port (server included) has neither
  ``jax`` nor any ``nomad_tpu`` module loaded;
* an AST scan of every module of the port and of ``chip_smoke.py`` finds
  no such import;
* asking for the card where there is none raises, and ``chip_smoke.py``
  exits non-zero without printing a result, both with no card and when it
  stands alone in a directory.
"""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "nomad_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "nomad_tpu")


def forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_loads_no_jax_and_no_reference():
    # Only what the port's import adds counts: an interpreter start-up hook
    # that preloads modules is not the port's doing.
    code = (
        "import json, sys\n"
        "before = set(sys.modules)\n"
        "import nomad_tpu_torch, nomad_tpu_torch.server\n"
        "import nomad_tpu_torch.server.server, nomad_tpu_torch.ops.kernels\n"
        "import nomad_tpu_torch.ops.build, nomad_tpu_torch.state.carry\n"
        "import nomad_tpu_torch.scheduler, nomad_tpu_torch.entry\n"
        "import nomad_tpu_torch.parallel, nomad_tpu_torch.obs\n"
        "import nomad_tpu_torch.stream, nomad_tpu_torch.state.wal\n"
        "import nomad_tpu_torch.structs.serde, nomad_tpu_torch.retry\n"
        "import nomad_tpu_torch.api.agent, nomad_tpu_torch.api.http_server\n"
        "import nomad_tpu_torch.api.rpc, nomad_tpu_torch.api.config_file\n"
        "import nomad_tpu_torch.cli\n"
        "print(json.dumps(sorted(set(sys.modules) - before)))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=str(REPO), timeout=120)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "nomad_tpu_torch.server.server" in loaded
    assert "nomad_tpu_torch.parallel.sharding" in loaded
    assert "nomad_tpu_torch.obs.evaluator" in loaded
    assert "nomad_tpu_torch.stream.broker" in loaded
    assert "nomad_tpu_torch.api.http_server" in loaded
    assert "nomad_tpu_torch.api.rpc" in loaded
    assert "nomad_tpu_torch.cli" in loaded
    bad = [m for m in loaded if forbidden(m)]
    assert bad == []


def imports_of(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_no_module_imports_jax_or_reference():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 20
    for must in ("entry.py", "parallel/__init__.py", "parallel/sharding.py",
                 "api/http_server.py", "api/rpc.py", "cli.py"):
        assert PORT / must in files
    bad = {str(f.relative_to(REPO)): name
           for f in files for name in imports_of(f) if forbidden(name)}
    assert bad == {}


def test_server_without_card_raises(monkeypatch):
    from nomad_tpu_torch.scheduler.coalescer import DeviceCoalescer
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.state.matrix import NodeMatrix

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Server(ServerConfig(num_workers=1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeviceCoalescer(NodeMatrix(capacity=16))
    # Asking for the CPU explicitly is the one way onto it.
    Server(ServerConfig(num_workers=1), device="cpu")


def run_smoke(cwd: Path, script: Path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, even on a host that has one
    return subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, env=env, cwd=str(cwd), timeout=300)


def test_chip_smoke_fails_without_card():
    out = run_smoke(REPO, REPO / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_fails_alone(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(REPO / "chip_smoke.py", script)
    out = run_smoke(tmp_path, script)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_sharded_paths_without_card_raise(monkeypatch):
    """A device list that names the card raises where there is none, at
    every entry of the node-sharded dispatch; the CPU list is the one way
    onto the plain versions."""
    from nomad_tpu_torch.entry import dryrun_multichip
    from nomad_tpu_torch.ops import build
    from nomad_tpu_torch.parallel import make_mesh
    from nomad_tpu_torch.scheduler.coalescer import DeviceCoalescer
    from nomad_tpu_torch.server.server import Server, ServerConfig
    from nomad_tpu_torch.state.matrix import NodeMatrix

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (
        lambda: make_mesh(),
        lambda: make_mesh(4, devices=["cuda:0"] * 4),
        lambda: Server(ServerConfig(num_workers=1), device=["cuda:0"] * 2),
        lambda: DeviceCoalescer(NodeMatrix(capacity=16),
                                device=["cuda:0"] * 2),
        lambda: dryrun_multichip(4, "cuda:0"),
    ):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    Server(ServerConfig(num_workers=1), device=["cpu"] * 2)
    assert "sharded_place" in build.KERNELS
    for name in build.KERNELS:
        src = (PORT / "ops" / "csrc" / f"{name}.cu").read_text()
        assert '#include "layout.cuh"' in src
