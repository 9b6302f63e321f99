"""
Minimal UTC datetime type of the detection engine's host path.

Namesake of detex_tpu/core/utc.py (a copy: the port imports nothing of
detex_tpu). A small, numpy-friendly subset of ``obspy.UTCDateTime``:

- construction from float/int POSIX timestamps, ISO-8601 strings (both
  ``:`` and detex-style ``-`` time separators, e.g. ``2007-12-05T19-16-32``),
  other UTCDateTime instances, and datetime objects
- ``timestamp``, ``datetime``, ``year``, ``julday``, ``hour``, ``minute``,
  ``second``, ``microsecond``
- arithmetic with seconds (+/-), differences, rich comparisons
- ISO string repr ending in 'Z'
"""
from __future__ import annotations

import datetime as _dt
import re
from functools import total_ordering

_EPOCH = _dt.datetime(1970, 1, 1, tzinfo=_dt.timezone.utc)

# 2009-04-01T12-30-05(.123)  or  2009-04-01T12:30:05(.123)(Z)
_ISO_RE = re.compile(
    r"^(\d{4})[-/](\d{1,2})[-/](\d{1,2})"
    r"(?:[T ](\d{1,2})[-:](\d{1,2})(?:[-:](\d{1,2}(?:\.\d+)?))?)?Z?$"
)
_COMPACT_RE = re.compile(r"^(\d{4})(\d{2})(\d{2})T?(\d{2})(\d{2})(\d{2})$")


@total_ordering
class UTCDateTime(object):
    """POSIX-timestamp-backed UTC datetime (subset of obspy.UTCDateTime)."""

    __slots__ = ("_ts",)

    def __init__(self, value=None, *args):
        if value is None:
            self._ts = _dt.datetime.now(_dt.timezone.utc).timestamp()
        elif isinstance(value, UTCDateTime):
            self._ts = value._ts
        elif isinstance(value, (int, float)):
            if args:  # (year, month, day[, hour, minute, second[, micro]])
                parts = (int(value),) + tuple(int(a) for a in args[:5])
                micro = int(args[5]) if len(args) > 5 else 0
                while len(parts) < 6:
                    parts = parts + (0,) if len(parts) > 2 else parts + (1,)
                d = _dt.datetime(*parts, microsecond=micro,
                                 tzinfo=_dt.timezone.utc)
                self._ts = (d - _EPOCH).total_seconds()
            else:
                self._ts = float(value)
        elif isinstance(value, _dt.datetime):
            if value.tzinfo is None:
                value = value.replace(tzinfo=_dt.timezone.utc)
            self._ts = (value - _EPOCH).total_seconds()
        elif isinstance(value, str):
            self._ts = _parse_str(value)
        else:
            # numpy scalars etc.
            try:
                self._ts = float(value)
            except Exception:
                raise ValueError("cannot interpret %r as UTCDateTime"
                                 % (value,))

    # -- properties -------------------------------------------------------
    @property
    def timestamp(self):
        return self._ts

    @property
    def datetime(self):
        return _EPOCH + _dt.timedelta(seconds=self._ts)

    @property
    def year(self):
        return self.datetime.year

    @property
    def month(self):
        return self.datetime.month

    @property
    def day(self):
        return self.datetime.day

    @property
    def julday(self):
        return self.datetime.timetuple().tm_yday

    @property
    def hour(self):
        return self.datetime.hour

    @property
    def minute(self):
        return self.datetime.minute

    @property
    def second(self):
        return self.datetime.second

    @property
    def microsecond(self):
        return self.datetime.microsecond

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, other):
        return UTCDateTime(self._ts + float(other))

    __radd__ = __add__

    def __sub__(self, other):
        if isinstance(other, UTCDateTime):
            return self._ts - other._ts
        return UTCDateTime(self._ts - float(other))

    def __eq__(self, other):
        try:
            return abs(self._ts - UTCDateTime(other)._ts) < 1e-6
        except Exception:
            return NotImplemented

    def __lt__(self, other):
        return self._ts < UTCDateTime(other)._ts

    def __hash__(self):
        return hash(round(self._ts, 6))

    def __float__(self):
        return self._ts

    # -- repr ---------------------------------------------------------------
    def isoformat(self):
        d = self.datetime
        frac = d.microsecond
        base = d.strftime("%Y-%m-%dT%H:%M:%S")
        return "%s.%06d" % (base, frac)

    def __str__(self):
        return self.isoformat() + "Z"

    def __repr__(self):
        return "UTCDateTime(%s)" % str(self)


def _parse_str(s):
    s = s.strip()
    # plain number in a string
    try:
        return float(s)
    except ValueError:
        pass
    m = _ISO_RE.match(s)
    if m:
        y, mo, d, h, mi, sec = m.groups()
        h = h or 0
        mi = mi or 0
        sec = sec or 0
        secf = float(sec)
        whole = int(secf)
        micro = int(round((secf - whole) * 1e6))
        dt = _dt.datetime(int(y), int(mo), int(d), int(h), int(mi), whole,
                          micro, tzinfo=_dt.timezone.utc)
        return (dt - _EPOCH).total_seconds()
    m = _COMPACT_RE.match(s)
    if m:
        y, mo, d, h, mi, sec = (int(x) for x in m.groups())
        dt = _dt.datetime(y, mo, d, h, mi, sec, tzinfo=_dt.timezone.utc)
        return (dt - _EPOCH).total_seconds()
    raise ValueError("cannot parse %r as UTCDateTime" % s)
