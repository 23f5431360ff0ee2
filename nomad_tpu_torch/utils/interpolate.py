"""`${var}` interpolation for job fields.

Reference: helper/args (ReplaceEnv) + client/driver/env/env.go
(ParseAndReplace) — task env values, driver config strings, and service
names/tags may reference `${NOMAD_*}` variables (and node attributes in
constraint targets, scheduler/feasible.py). Unknown variables are left
verbatim, matching the reference's behavior.
"""

from __future__ import annotations

import re
from typing import Any, Dict

_VAR_RE = re.compile(r"\$\{([^}]+)\}")


def replace_env(text: str, env: Dict[str, str]) -> str:
    def sub(m: re.Match) -> str:
        val = env.get(m.group(1).strip())
        return val if val is not None else m.group(0)

    return _VAR_RE.sub(sub, text)


def interpolate_value(value: Any, env: Dict[str, str]) -> Any:
    """Recursively interpolate strings inside config-shaped values."""
    if isinstance(value, str):
        return replace_env(value, env)
    if isinstance(value, list):
        return [interpolate_value(v, env) for v in value]
    if isinstance(value, dict):
        return {k: interpolate_value(v, env) for k, v in value.items()}
    return value
