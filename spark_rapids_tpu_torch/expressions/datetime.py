"""Civil-date arithmetic on int64 tensors.

Counterpart of ``spark_rapids_tpu/expressions/datetime.py``, cut to the
two conversions the casts use: ``_civil_from_days`` (:36) and
``_days_from_civil`` (:58), Howard Hinnant's public-domain construction
in integer arithmetic over the proleptic Gregorian calendar.  A DATE is
int32 days since 1970-01-01.  The date and timestamp expressions keep
this module's name for when they are ported.
"""
from __future__ import annotations

from typing import Tuple

import torch


def _civil_from_days(z: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Days since 1970-01-01 -> (year, month in [1, 12], day in [1, 31]),
    int64."""
    z = z.to(torch.int64) + 719468
    era = torch.div(torch.where(z >= 0, z, z - 146096), 146097,
                    rounding_mode="floor")
    doe = z - era * 146097                                 # [0, 146096]
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)        # [0, 365]
    mp = (5 * doy + 2) // 153                              # [0, 11]
    d = doy - (153 * mp + 2) // 5 + 1                      # [1, 31]
    m = torch.where(mp < 10, mp + 3, mp - 9)               # [1, 12]
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def _days_from_civil(y: torch.Tensor, m: torch.Tensor,
                     d: torch.Tensor) -> torch.Tensor:
    """(year, month, day) -> int64 days since 1970-01-01."""
    m = m.to(torch.int64)
    y = y.to(torch.int64) - (m <= 2).to(torch.int64)
    era = torch.div(torch.where(y >= 0, y, y - 399), 400,
                    rounding_mode="floor")
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9)
    doy = (153 * mp + 2) // 5 + d.to(torch.int64) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468
