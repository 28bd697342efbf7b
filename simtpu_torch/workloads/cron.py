"""Cron-expression parsing shared by CronJob surfaces.

Two consumers, one grammar (the satellite contract of ISSUE 15): the
static expansion path (`expand.make_valid_pods_by_cron_job`) validates
`spec.schedule` through the same parser the timeline's firing generator
(`simtpu/timeline/events.py`) walks to materialize real fire times — a
schedule the static path accepts can never blow up mid-replay, and a
malformed one fails both surfaces with the same one-line `SpecError`
field path.

Grammar: the standard 5-field crontab line `minute hour day-of-month
month day-of-week`, each field `*`, a number, a range `a-b`, a step
`*/n` or `a-b/n`, or a comma list of those.  Names (`jan`, `mon`) and
the `@hourly` macros follow the Kubernetes CronJob controller's
accepted forms (robfig/cron v3 standard parser).  Day-of-month and
day-of-week compose with cron's classic OR rule: when BOTH are
restricted, a time matches if EITHER does.

Simulation time is seconds from an epoch; fire-time enumeration walks
whole minutes from a base wall-clock anchored at the Unix epoch (UTC) —
deterministic, timezone-free, and documented in docs/timeline.md.
"""

from __future__ import annotations

from dataclasses import dataclass
from datetime import datetime, timedelta, timezone
from typing import List, Optional, Tuple

from .validate import SpecError

#: (low, high) inclusive bounds per field, in field order
_BOUNDS = ((0, 59), (0, 23), (1, 31), (1, 12), (0, 6))
_FIELD_NAMES = ("minute", "hour", "day-of-month", "month", "day-of-week")

_MONTH_NAMES = {
    name: i + 1
    for i, name in enumerate(
        ("jan", "feb", "mar", "apr", "may", "jun",
         "jul", "aug", "sep", "oct", "nov", "dec")
    )
}
_DOW_NAMES = {
    name: i
    for i, name in enumerate(("sun", "mon", "tue", "wed", "thu", "fri", "sat"))
}

#: the @-macros the Kubernetes controller accepts (robfig/cron); @reboot
#: deliberately absent — a simulated cluster has no boot instant
_MACROS = {
    "@yearly": "0 0 1 1 *",
    "@annually": "0 0 1 1 *",
    "@monthly": "0 0 1 * *",
    "@weekly": "0 0 * * 0",
    "@daily": "0 0 * * *",
    "@midnight": "0 0 * * *",
    "@hourly": "0 * * * *",
}


def _atom(token: str, idx: int) -> int:
    """One numeric atom of field `idx`, with month/dow name support and
    cron's `7 == Sunday` alias."""
    low, high = _BOUNDS[idx]
    names = _MONTH_NAMES if idx == 3 else _DOW_NAMES if idx == 4 else None
    if names is not None and token.lower() in names:
        return names[token.lower()]
    if not token.isdigit():
        raise ValueError(f"{_FIELD_NAMES[idx]}: not a number: {token!r}")
    v = int(token)
    if idx == 4 and v == 7:
        v = 0
    if not low <= v <= high:
        raise ValueError(
            f"{_FIELD_NAMES[idx]}: {v} outside [{low}, {high}]"
        )
    return v


def _parse_field(field: str, idx: int) -> Tuple[frozenset, bool]:
    """One cron field -> (allowed value set, was-unrestricted)."""
    low, high = _BOUNDS[idx]
    allowed = set()
    star = False
    if not field:
        raise ValueError(f"{_FIELD_NAMES[idx]}: empty field")
    for part in field.split(","):
        step = 1
        if "/" in part:
            part, _, step_s = part.partition("/")
            if not step_s.isdigit() or int(step_s) < 1:
                raise ValueError(
                    f"{_FIELD_NAMES[idx]}: bad step {step_s!r}"
                )
            step = int(step_s)
        if part == "*":
            a, b = low, high
            if step == 1:
                star = True
        elif "-" in part:
            a_s, _, b_s = part.partition("-")
            a, b = _atom(a_s, idx), _atom(b_s, idx)
            if b < a:
                raise ValueError(
                    f"{_FIELD_NAMES[idx]}: inverted range {part!r}"
                )
        else:
            a = b = _atom(part, idx)
        allowed.update(range(a, b + 1, step))
    return frozenset(allowed), star


@dataclass(frozen=True)
class CronSchedule:
    """A parsed 5-field schedule: per-field allowed-value sets plus the
    dom/dow restriction flags the OR rule needs."""

    expr: str
    minutes: frozenset
    hours: frozenset
    doms: frozenset
    months: frozenset
    dows: frozenset
    dom_star: bool
    dow_star: bool

    def matches(self, dt: datetime) -> bool:
        """Whole-minute match (seconds ignored, as cron does)."""
        if dt.minute not in self.minutes or dt.hour not in self.hours:
            return False
        if dt.month not in self.months:
            return False
        dom_ok = dt.day in self.doms
        dow_ok = ((dt.weekday() + 1) % 7) in self.dows  # cron: Sunday = 0
        if self.dom_star or self.dow_star:
            return dom_ok and dow_ok
        return dom_ok or dow_ok  # both restricted: classic cron OR

    def next_fire(self, after_s: float, limit_days: int = 366 * 4) -> Optional[float]:
        """The first fire time STRICTLY after `after_s` (seconds from the
        Unix epoch, UTC), or None when none exists within `limit_days`
        (an impossible dom/month combination, e.g. `0 0 31 2 *`)."""
        dt = datetime.fromtimestamp(float(after_s), tz=timezone.utc)
        dt = dt.replace(second=0, microsecond=0) + timedelta(minutes=1)
        end = dt + timedelta(days=limit_days)
        while dt < end:
            if dt.month not in self.months:
                # skip to the 1st of the next month in one hop
                if dt.month == 12:
                    dt = dt.replace(year=dt.year + 1, month=1, day=1,
                                    hour=0, minute=0)
                else:
                    dt = dt.replace(month=dt.month + 1, day=1, hour=0,
                                    minute=0)
                continue
            dom_ok = dt.day in self.doms
            dow_ok = ((dt.weekday() + 1) % 7) in self.dows
            day_ok = (
                (dom_ok and dow_ok)
                if (self.dom_star or self.dow_star)
                else (dom_ok or dow_ok)
            )
            if not day_ok:
                dt = (dt + timedelta(days=1)).replace(hour=0, minute=0)
                continue
            if dt.hour not in self.hours:
                dt = (dt + timedelta(hours=1)).replace(minute=0)
                continue
            if dt.minute not in self.minutes:
                dt += timedelta(minutes=1)
                continue
            return dt.timestamp()
        return None


def parse_schedule(expr: str, field: str = "spec.schedule") -> CronSchedule:
    """Parse one CronJob schedule, raising a `SpecError` (one actionable
    line through `expand.spec_context`) on any malformed input."""
    if not isinstance(expr, str) or not expr.strip():
        raise SpecError("empty cron schedule", field=field)
    text = _MACROS.get(expr.strip().lower(), expr.strip())
    fields = text.split()
    if len(fields) != 5:
        raise SpecError(
            f"cron schedule needs 5 fields (minute hour dom month dow), "
            f"got {len(fields)}: {expr!r}",
            field=field,
        )
    try:
        minutes, _ = _parse_field(fields[0], 0)
        hours, _ = _parse_field(fields[1], 1)
        doms, dom_star = _parse_field(fields[2], 2)
        months, _ = _parse_field(fields[3], 3)
        dows, dow_star = _parse_field(fields[4], 4)
    except ValueError as exc:
        raise SpecError(
            f"bad cron schedule {expr!r}: {exc}", field=field
        ) from None
    return CronSchedule(
        expr=expr,
        minutes=minutes,
        hours=hours,
        doms=doms,
        months=months,
        dows=dows,
        dom_star=dom_star,
        dow_star=dow_star,
    )


def fire_times(
    schedule: CronSchedule,
    start_s: float,
    end_s: float,
    starting_deadline_s: Optional[float] = None,
    max_fires: int = 100_000,
) -> List[float]:
    """Every fire time in the half-open window `(start_s, end_s]`,
    seconds from the Unix epoch.

    `starting_deadline_s` mirrors `spec.startingDeadlineSeconds`: when
    the window opens, the controller catches up AT MOST the single most
    recent missed run whose schedule time lies within the deadline
    (`cronjob_controllerv2.go` starts only the latest missed run; older
    ones are skipped).  That one fire surfaces at its ORIGINAL schedule
    time (<= start_s; the replay loop admits it at window start).
    `max_fires` bounds a pathological `* * * * *` over a huge window
    loudly rather than silently truncating."""
    out: List[float] = []
    if starting_deadline_s is not None:
        # latest missed run in [start_s - deadline, start_s]
        t = float(start_s) - float(starting_deadline_s)
        missed = None
        while True:
            nxt = schedule.next_fire(t)
            if nxt is None or nxt > start_s:
                break
            missed = nxt
            t = nxt
        if missed is not None:
            out.append(missed)
    t = float(start_s)
    while True:
        nxt = schedule.next_fire(t)  # strictly after t: (start_s, end_s]
        if nxt is None or nxt > end_s:
            break
        out.append(nxt)
        if len(out) > max_fires:
            raise ValueError(
                f"cron schedule {schedule.expr!r} fires more than "
                f"{max_fires} times in the window; shrink the horizon"
            )
        t = nxt
    return out


def cron_job_schedule(cronjob: dict, field: str = "spec.schedule") -> CronSchedule:
    """The parsed schedule of one CronJob object (SpecError on absence —
    the API server rejects a CronJob without spec.schedule too)."""
    expr = (cronjob.get("spec") or {}).get("schedule")
    if expr is None:
        raise SpecError("CronJob has no spec.schedule", field=field)
    return parse_schedule(expr, field=field)


def cron_job_suspended(cronjob: dict) -> bool:
    """`spec.suspend: true` — the controller creates no Jobs while set."""
    return bool((cronjob.get("spec") or {}).get("suspend"))
