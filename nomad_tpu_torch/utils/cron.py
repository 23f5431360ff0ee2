"""Minimal 5-field cron schedule used by periodic jobs.

The reference relies on gorhill/cronexpr (nomad/periodic.go via
structs.PeriodicConfig.Next). Supported syntax here: "*", "*/n", lists
"a,b,c", ranges "a-b", and combinations, over minute hour day-of-month
month day-of-week.
"""

from __future__ import annotations

import calendar
import time
from typing import List, Set

_FIELD_RANGES = [(0, 59), (0, 23), (1, 31), (1, 12), (0, 6)]


def _parse_field(expr: str, lo: int, hi: int) -> Set[int]:
    out: Set[int] = set()
    for part in expr.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            step = int(step_s)
            if step < 1:
                raise ValueError(f"cron step must be >= 1, got {step}")
        if part == "*" or part == "":
            rng = range(lo, hi + 1)
        elif "-" in part:
            a, b = part.split("-", 1)
            rng = range(int(a), int(b) + 1)
        else:
            rng = range(int(part), int(part) + 1)
        start = rng.start  # steps anchor to the range start, per standard cron
        for v in rng:
            if not (lo <= v <= hi):
                raise ValueError(f"cron field value {v} out of range [{lo},{hi}]")
            if (v - start) % step == 0:
                out.add(v)
    if not out:
        raise ValueError(f"empty cron field {expr!r}")
    return out


class CronSchedule:
    def __init__(self, spec: str):
        fields = spec.split()
        if len(fields) != 5:
            raise ValueError(f"expected 5 cron fields, got {len(fields)}")
        self.minutes, self.hours, self.days, self.months, self.weekdays = (
            _parse_field(f, lo, hi) for f, (lo, hi) in zip(fields, _FIELD_RANGES)
        )
        self.any_day = fields[2] == "*"
        self.any_weekday = fields[4] == "*"

    def _day_match(self, year: int, month: int, day: int) -> bool:
        # cron semantics: if both dom and dow are restricted, either may match
        dom_ok = day in self.days
        # Python: Monday=0..Sunday=6; cron: Sunday=0..Saturday=6
        wd = (calendar.weekday(year, month, day) + 1) % 7
        dow_ok = wd in self.weekdays
        if self.any_day and self.any_weekday:
            return True
        if self.any_day:
            return dow_ok
        if self.any_weekday:
            return dom_ok
        return dom_ok or dow_ok

    def next_after(self, after: float) -> float:
        """Next matching time strictly after `after` (unix seconds, local)."""
        t = time.localtime(after + 60 - (after % 60))
        year, month, day = t.tm_year, t.tm_mon, t.tm_mday
        hour, minute = t.tm_hour, t.tm_min
        for _ in range(366 * 5 * 24 * 60):  # bounded search
            if month not in self.months:
                month += 1
                if month > 12:
                    month, year = 1, year + 1
                day, hour, minute = 1, 0, 0
                continue
            if day > calendar.monthrange(year, month)[1] or not self._day_match(year, month, day):
                day += 1
                hour, minute = 0, 0
                if day > calendar.monthrange(year, month)[1]:
                    day, month = 1, month + 1
                    if month > 12:
                        month, year = 1, year + 1
                continue
            if hour not in self.hours:
                hour += 1
                minute = 0
                if hour > 23:
                    hour = 0
                    day += 1
                continue
            if minute not in self.minutes:
                minute += 1
                if minute > 59:
                    minute = 0
                    hour += 1
                continue
            return time.mktime((year, month, day, hour, minute, 0, 0, 0, -1))
        raise ValueError("no matching time found within 5 years")
