"""HTTP API + agent (reference: command/agent/ — http.go:252-324 routes).

The reference package's exports, loaded on first use: the CLI's commands
other than ``agent`` import ``api.client`` alone, and so never import the
server (nor torch).
"""

import importlib

_EXPORTS = {
    "Agent": ".agent",
    "AgentConfig": ".agent",
    "HTTPAPIServer": ".http_server",
    "APIClient": ".client",
}

__all__ = ["Agent", "AgentConfig", "HTTPAPIServer", "APIClient"]


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_EXPORTS[name], __name__), name)
