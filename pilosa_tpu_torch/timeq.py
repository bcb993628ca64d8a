"""Time quantum view-name math (port of reference time.go).

Views for time fields are named "<base>_<YYYY[MM[DD[HH]]]>"; a range query
covers [start, end) with the minimal set of quantum views by walking up from
small units to aligned boundaries, then back down.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import List

VALID_QUANTUMS = {"Y", "YM", "YMD", "YMDH", "M", "MD", "MDH", "D", "DH", "H", ""}


def parse_time_quantum(v: str) -> str:
    q = (v or "").upper()
    if q not in VALID_QUANTUMS:
        from .errors import InvalidTimeQuantumError

        raise InvalidTimeQuantumError(v)
    return q


def view_by_time_unit(name: str, t: datetime, unit: str) -> str:
    if unit == "Y":
        return f"{name}_{t.strftime('%Y')}"
    if unit == "M":
        return f"{name}_{t.strftime('%Y%m')}"
    if unit == "D":
        return f"{name}_{t.strftime('%Y%m%d')}"
    if unit == "H":
        return f"{name}_{t.strftime('%Y%m%d%H')}"
    return ""


def views_by_time(name: str, t: datetime, quantum: str) -> List[str]:
    return [v for u in quantum if (v := view_by_time_unit(name, t, u))]


def _add_months(t: datetime, n: int) -> datetime:
    """Go time.AddDate month semantics: out-of-range days normalize forward
    (Jan 31 + 1 month = Mar 3, or Mar 2 in leap years), they don't clamp."""
    month = t.month - 1 + n
    year = t.year + month // 12
    first = t.replace(year=year, month=month % 12 + 1, day=1)
    return first + timedelta(days=t.day - 1)


def _next_year_gte(t: datetime, end: datetime) -> bool:
    nxt = t.replace(year=t.year + 1)
    return nxt.year == end.year or end > nxt


def _next_month_gte(t: datetime, end: datetime) -> bool:
    nxt = _add_months(t, 1)
    return (nxt.year, nxt.month) == (end.year, end.month) or end > nxt


def _next_day_gte(t: datetime, end: datetime) -> bool:
    nxt = t + timedelta(days=1)
    return (nxt.year, nxt.month, nxt.day) == (end.year, end.month, end.day) or end > nxt


def views_by_time_range(name: str, start: datetime, end: datetime, quantum: str) -> List[str]:
    t = start
    has_y, has_m = "Y" in quantum, "M" in quantum
    has_d, has_h = "D" in quantum, "H" in quantum
    results: List[str] = []

    # Walk up from smallest units to largest.
    if has_h or has_d or has_m:
        while t < end:
            if has_h:
                if not _next_day_gte(t, end):
                    break
                if t.hour != 0:
                    results.append(view_by_time_unit(name, t, "H"))
                    t += timedelta(hours=1)
                    continue
            if has_d:
                if not _next_month_gte(t, end):
                    break
                if t.day != 1:
                    results.append(view_by_time_unit(name, t, "D"))
                    t += timedelta(days=1)
                    continue
            if has_m:
                if not _next_year_gte(t, end):
                    break
                if t.month != 1:
                    results.append(view_by_time_unit(name, t, "M"))
                    t = _add_months(t, 1)
                    continue
            break

    # Walk back down from largest units to smallest.
    while t < end:
        if has_y and _next_year_gte(t, end):
            results.append(view_by_time_unit(name, t, "Y"))
            t = t.replace(year=t.year + 1)
        elif has_m and _next_month_gte(t, end):
            results.append(view_by_time_unit(name, t, "M"))
            t = _add_months(t, 1)
        elif has_d and _next_day_gte(t, end):
            results.append(view_by_time_unit(name, t, "D"))
            t += timedelta(days=1)
        elif has_h:
            results.append(view_by_time_unit(name, t, "H"))
            t += timedelta(hours=1)
        else:
            break

    return results


TIMESTAMP_FORMAT = "%Y-%m-%dT%H:%M"


def parse_timestamp(v: str) -> datetime:
    return datetime.strptime(v, TIMESTAMP_FORMAT)
