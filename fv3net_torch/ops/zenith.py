"""Solar zenith angle and Earth-Sun distance (port of
``fv3net_tpu/ops/zenith.py``): the astronomy takes float days since
2000-01-01T12:00 UTC; a host helper converts datetimes."""
from __future__ import annotations

import datetime
import math

import numpy as np
import torch

_EPOCH = datetime.datetime(2000, 1, 1, 12, 0)


def days_from_2000(time) -> np.ndarray:
    """Host-side: datetime(-like, or an array of them) to float days since
    2000-01-01T12:00 UTC."""
    arr = np.asarray(time)
    flat = arr.ravel()
    out = np.empty(flat.shape, dtype=np.float64)
    for i, t in enumerate(flat):
        t = t.item() if hasattr(t, "item") else t
        delta = t - _EPOCH if isinstance(t, datetime.datetime) else t - type(t)(
            2000, 1, 1, 12, 0
        )
        out[i] = delta.total_seconds() / 86400.0
    return out.reshape(arr.shape) if arr.shape else out[0]


def _greenwich_mean_sidereal_time(days):
    jc = days / 36525.0
    theta = 67310.54841 + jc * (
        876600 * 3600 + 8640184.812866 + jc * (0.093104 - jc * 6.2e-5)
    )
    return torch.deg2rad(theta / 240.0) % (2 * math.pi)


def _sun_ecliptic_longitude(days):
    jc = days / 36525.0
    mean_anomaly = torch.deg2rad(
        357.52910 + 35999.05030 * jc - 0.0001559 * jc * jc
        - 0.00000048 * jc ** 3
    )
    mean_longitude = torch.deg2rad(
        280.46645 + 36000.76983 * jc + 0.0003032 * jc ** 2
    )
    d_l = torch.deg2rad(
        (1.914600 - 0.004817 * jc - 0.000014 * jc ** 2)
        * torch.sin(mean_anomaly)
        + (0.019993 - 0.000101 * jc) * torch.sin(2 * mean_anomaly)
        + 0.000290 * torch.sin(3 * mean_anomaly)
    )
    return mean_longitude + d_l


def _obliquity(jc):
    return torch.deg2rad(
        23.0 + 26.0 / 60 + 21.406 / 3600.0
        - (46.836769 * jc - 0.0001831 * jc ** 2 + 0.00200340 * jc ** 3
           - 0.576e-6 * jc ** 4 - 4.34e-8 * jc ** 5) / 3600.0
    )


def _right_ascension_declination(days):
    jc = days / 36525.0
    eps = _obliquity(jc)
    eclon = _sun_ecliptic_longitude(days)
    x = torch.cos(eclon)
    y = torch.cos(eps) * torch.sin(eclon)
    z = torch.sin(eps) * torch.sin(eclon)
    r = torch.sqrt(1.0 - z * z)
    return 2 * torch.atan2(y, x + r), torch.atan2(z, r)


def cos_zenith_angle(days, lon_deg, lat_deg):
    """Cosine of the solar zenith angle.  ``days``: float days since
    2000-01-01T12:00 UTC, a tensor broadcastable against lon/lat (in
    degrees)."""
    days = torch.as_tensor(days, dtype=lon_deg.dtype, device=lon_deg.device)
    lon = torch.deg2rad(lon_deg)
    lat = torch.deg2rad(lat_deg)
    ra, dec = _right_ascension_declination(days)
    h_angle = _greenwich_mean_sidereal_time(days) + lon - ra
    return (torch.sin(lat) * torch.sin(dec)
            + torch.cos(lat) * torch.cos(dec) * torch.cos(h_angle))


def solar_distance_factor(days) -> float:
    """(a/r)^2 Earth-Sun distance factor for the solar "constant"
    (Spencer 1971 Fourier series in the day angle), of host float days."""
    g = 2.0 * math.pi * ((days - 0.5) % 365.25) / 365.25
    return float(
        1.000110 + 0.034221 * np.cos(g) + 0.001280 * np.sin(g)
        + 0.000719 * np.cos(2.0 * g) + 0.000077 * np.sin(2.0 * g)
    )
