"""Time manager and alarm system (tmngr.F, switch.F).

Port of ``uvic_tpu.core.calendar``, pure Python and unchanged: a
host-side ``TimeManager`` tracks model time in days and ``Alarm``s fire
when the time crosses a multiple of their interval, the "cron" that
cadences diagnostics, averaging windows and restarts.  The float
arithmetic on ``days`` is the reference's, so the alarms fire on the
same segments in both packages.

Calendars: the equal-month year (12 x 30 days, UVic_ESCM.F:1421-1423)
and a Julian 365-day year.
"""

from __future__ import annotations

from dataclasses import dataclass, field


MONTH_NAMES = ("Jan", "Feb", "Mar", "Apr", "May", "Jun",
               "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")
_JULIAN_MONLEN = (31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31)


@dataclass
class TimeManager:
    """Tracks model time in days since (year0, month0, day0)."""
    eqyear: bool = True
    eqmon: bool = False
    year0: int = 0
    month0: int = 1
    day0: int = 1
    itt: int = 0
    days: float = 0.0       # elapsed model days since start

    @property
    def yrlen(self) -> float:
        return 360.0 if self.eqyear else 365.0

    def monlen(self, month: int) -> int:
        if self.eqyear:
            return 30
        return _JULIAN_MONLEN[month - 1]

    def increment(self, dt_seconds: float):
        """Advance the clock one step (tmngr.F increment_time)."""
        self.itt += 1
        self.days += dt_seconds / 86400.0

    @property
    def date(self):
        """(year, month, day, hour, min, sec) like mkstmp (tmngr.F:871)."""
        total = self.days + (self.day0 - 1)
        year = self.year0
        month = self.month0
        while True:
            ml = self.monlen(month)
            if total < ml:
                break
            total -= ml
            month += 1
            if month > 12:
                month = 1
                year += 1
        day = int(total) + 1
        frac = total - int(total)
        hh = int(frac * 24)
        mm = int((frac * 24 - hh) * 60)
        ss = int(round(((frac * 24 - hh) * 60 - mm) * 60))
        return (year, month, day, hh, mm, ss)

    def stamp(self) -> str:
        y, mo, d, hh, mm, ss = self.date
        return f"{y:04d}-{mo:02d}-{d:02d} {hh:02d}:{mm:02d}:{ss:02d}"


@dataclass
class Alarm:
    """Interval alarm (switch.F `alarm`/`avg_alarm`): fires when the
    model time crosses a multiple of ``interval`` days.  A negative or
    zero interval never fires (the reference convention for disabled
    diagnostics, e.g. tavgint=-365000)."""
    interval: float                 # days
    last_fired: float = field(default=-1.0e30)

    def check(self, days: float, dt_days: float) -> bool:
        """True if the step ending at ``days`` crosses an interval
        boundary (evaluated once per step)."""
        if self.interval <= 0.0:
            return False
        n_prev = int((days - dt_days + 1e-9) // self.interval)
        n_now = int((days + 1e-9) // self.interval)
        if n_now > n_prev and days - self.last_fired > 0.5 * self.interval:
            self.last_fired = days
            return True
        return False


@dataclass
class Switches:
    """The per-step switch set (switch.h analogs) evaluated by the
    driver each coupled step (set_time_switches)."""
    tsi: Alarm
    timavg: Alarm
    restart: Alarm
    end_of_year: Alarm

    @classmethod
    def from_config(cls, tcfg):
        return cls(tsi=Alarm(tcfg.tsiint),
                   timavg=Alarm(tcfg.timavgint),
                   restart=Alarm(tcfg.restint),
                   end_of_year=Alarm(360.0 if tcfg.eqyear else 365.0))

    def evaluate(self, days: float, dt_days: float) -> dict:
        return dict(
            tsits=self.tsi.check(days, dt_days),
            timavgts=self.timavg.check(days, dt_days),
            restts=self.restart.check(days, dt_days),
            eoyear=self.end_of_year.check(days, dt_days),
        )
