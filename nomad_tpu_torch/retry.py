"""Environment knobs shared by the port's tuning variables."""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    """Tolerant integer env knob: unset, empty, or unparsable → default.
    The one parser for every ``NOMAD_TPU_*`` tuning variable, so a typo'd
    knob degrades to the default instead of crashing a server at import."""
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default
