"""Standard-library timestamp parsing (utils.sonde_specific.parse_datetime)
on the formats the frame decoders emit, with dateutil's ``default=``
semantics for time-only strings."""

import datetime

import pytest

from radiosonde_auto_rx_jax.station.telemetry import enrich_telemetry
from radiosonde_auto_rx_jax.utils.sonde_specific import (fix_datetime,
                                                         parse_datetime)

UTC = datetime.timezone.utc
NOW = datetime.datetime(2024, 5, 6, 12, 0, 0, tzinfo=UTC)


@pytest.mark.parametrize("text,want", [
    # RS41/M10/M20/DFM/RS92: ISO date-time, milliseconds, Z
    ("2024-01-02T03:04:05.123Z",
     datetime.datetime(2024, 1, 2, 3, 4, 5, 123000, tzinfo=UTC)),
    # MRZ/MTS01/meisei: ISO without a fraction
    ("2024-01-02T03:04:05Z", datetime.datetime(2024, 1, 2, 3, 4, 5,
                                               tzinfo=UTC)),
    # iMet-4/Weathex: time of day only -> the default's date
    ("03:04:05Z", datetime.datetime(2024, 5, 6, 3, 4, 5, tzinfo=UTC)),
    # LMS6/iMet-54: time of day with milliseconds
    ("23:59:59.250Z", datetime.datetime(2024, 5, 6, 23, 59, 59, 250000,
                                        tzinfo=UTC)),
    # RD41 dropsonde: centiseconds
    ("10:20:30.07Z", datetime.datetime(2024, 5, 6, 10, 20, 30, 70000,
                                       tzinfo=UTC)),
    # no zone: keeps the default's tzinfo
    ("2024-01-02 03:04:05", datetime.datetime(2024, 1, 2, 3, 4, 5,
                                              tzinfo=UTC)),
])
def test_parse_decoder_formats(text, want):
    assert parse_datetime(text, default=NOW) == want


def test_parse_rejects_garbage():
    with pytest.raises(ValueError):
        parse_datetime("not a time", default=NOW)


def test_fix_datetime_rolls_over_midnight():
    # a 23:59 fix received just after midnight belongs to yesterday
    got = fix_datetime("23:59:58Z", "2024-05-06T00:00:03Z")
    assert got == datetime.datetime(2024, 5, 5, 23, 59, 58, tzinfo=UTC)
    got = fix_datetime("00:00:02Z", "2024-05-06T23:59:59Z")
    assert got == datetime.datetime(2024, 5, 7, 0, 0, 2, tzinfo=UTC)


def test_enrich_telemetry_parses_iso():
    t = enrich_telemetry({"type": "RS41", "id": "S1234567", "frame": 1,
                          "datetime": "2024-01-02T03:04:05.500Z",
                          "lat": 1.0, "lon": 2.0, "alt": 3.0})
    assert t["datetime_dt"] == datetime.datetime(2024, 1, 2, 3, 4, 5,
                                                 500000, tzinfo=UTC)
