"""Version parsing and constraint checking for `version` constraints.

Reference behavior: hashicorp/go-version used by scheduler/feasible.go:380
(checkVersionConstraint). Supports constraint strings like
">= 1.2, < 2.0", "= 1.2.3", "~> 1.2" (pessimistic operator).
"""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

_VERSION_RE = re.compile(
    r"^v?(\d+(?:\.\d+)*)(?:-([0-9A-Za-z.\-~]+))?(?:\+([0-9A-Za-z.\-~]+))?$"
)


class Version:
    __slots__ = ("segments", "prerelease", "raw")

    def __init__(self, raw: str):
        m = _VERSION_RE.match(raw.strip())
        if not m:
            raise ValueError(f"malformed version: {raw!r}")
        self.raw = raw
        segs = [int(p) for p in m.group(1).split(".")]
        while len(segs) < 3:
            segs.append(0)
        self.segments = tuple(segs)
        self.prerelease = m.group(2) or ""

    def __lt__(self, other: "Version") -> bool:
        if self.segments != other.segments:
            return self.segments < other.segments
        if bool(self.prerelease) != bool(other.prerelease):
            return bool(self.prerelease)  # prerelease < release
        return _prerelease_lt(self.prerelease, other.prerelease)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Version)
            and self.segments == other.segments
            and self.prerelease == other.prerelease
        )

    def __le__(self, other):
        return self == other or self < other

    def __gt__(self, other):
        return not self <= other

    def __ge__(self, other):
        return not self < other

    def __hash__(self):
        return hash((self.segments, self.prerelease))

    def __repr__(self):
        return f"Version({self.raw!r})"


def _prerelease_lt(a: str, b: str) -> bool:
    """Semver prerelease ordering: dot-separated identifiers compare
    per-identifier, numeric ones numerically and below alphanumeric
    (so rc.9 < rc.10 and beta.2 < beta.11)."""
    for ai, bi in zip(a.split("."), b.split(".")):
        a_num, b_num = ai.isdigit(), bi.isdigit()
        if a_num and b_num:
            if int(ai) != int(bi):
                return int(ai) < int(bi)
        elif a_num != b_num:
            return a_num  # numeric identifiers sort below alphanumeric
        elif ai != bi:
            return ai < bi
    return len(a.split(".")) < len(b.split("."))


_CONSTRAINT_RE = re.compile(r"^\s*(=|!=|>=|<=|>|<|~>)?\s*([^\s,]+)\s*$")


class Constraint:
    __slots__ = ("op", "version", "precision")

    def __init__(self, raw: str):
        m = _CONSTRAINT_RE.match(raw)
        if not m:
            raise ValueError(f"malformed constraint: {raw!r}")
        self.op = m.group(1) or "="
        ver_str = m.group(2)
        # Track how many segments were written, for the pessimistic operator.
        core = ver_str.lstrip("v").split("-")[0].split("+")[0]
        self.precision = len(core.split("."))
        self.version = Version(ver_str)

    def check(self, v: Version) -> bool:
        c = self.version
        if self.op == "=":
            return v == c
        if self.op == "!=":
            return v != c
        if self.op == ">":
            return v > c
        if self.op == "<":
            return v < c
        if self.op == ">=":
            return v >= c
        if self.op == "<=":
            return v <= c
        if self.op == "~>":
            # ~> 1.2   allows >= 1.2, < 2.0
            # ~> 1.2.3 allows >= 1.2.3, < 1.3.0
            if v < c:
                return False
            lock = max(self.precision - 1, 1)
            return v.segments[:lock] == c.segments[:lock]
        return False


class Constraints:
    """A comma-separated conjunction of constraints."""

    def __init__(self, raw: str):
        parts = [p for p in raw.split(",") if p.strip()]
        if not parts:
            raise ValueError("empty constraint")
        self.constraints = [Constraint(p) for p in parts]

    def check(self, v: Version) -> bool:
        return all(c.check(v) for c in self.constraints)


def parse_version(raw: str) -> Optional[Version]:
    try:
        return Version(raw)
    except ValueError:
        return None


def parse_constraints(raw: str) -> Optional[Constraints]:
    try:
        return Constraints(raw)
    except ValueError:
        return None
