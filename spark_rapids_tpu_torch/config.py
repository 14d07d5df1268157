"""Session configuration of the port.

Counterpart of ``spark_rapids_tpu/config.py`` (``RapidsConf`` :927), cut to
the keys the q6 and q1 paths read.  Keys keep the reference's names; a key the
port does not know is kept and ignored, as Spark does with unknown confs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

SQL_ENABLED = "spark.rapids.sql.enabled"
BATCH_SIZE_ROWS = "spark.rapids.sql.batchSizeRows"
SHUFFLE_PARTITIONS = "spark.sql.shuffle.partitions"

_DEFAULTS = {
    SQL_ENABLED: True,
    # config.py:145-148 of the reference
    BATCH_SIZE_ROWS: 1 << 20,
    # config.py:184 of the reference
    SHUFFLE_PARTITIONS: 16,
}


def _to_bool(v) -> bool:
    if isinstance(v, str):
        return v.strip().lower() in ("true", "1", "yes")
    return bool(v)


class RapidsConf:
    """Immutable snapshot of the conf map, with typed accessors."""

    def __init__(self, conf_map: Optional[Dict[str, Any]] = None):
        self._map: Dict[str, Any] = dict(conf_map or {})
        if self.batch_size_rows < 1:
            raise ValueError(
                f"{BATCH_SIZE_ROWS} must be >= 1, got {self.batch_size_rows}")
        if self.shuffle_partitions < 1:
            raise ValueError(f"{SHUFFLE_PARTITIONS} must be >= 1, got "
                             f"{self.shuffle_partitions}")

    def _get(self, key: str):
        return self._map.get(key, _DEFAULTS[key])

    @property
    def sql_enabled(self) -> bool:
        return _to_bool(self._get(SQL_ENABLED))

    @property
    def batch_size_rows(self) -> int:
        """Row count of the batches a DataFrame built from host data is cut
        into (the scan's batch size)."""
        return int(self._get(BATCH_SIZE_ROWS))

    @property
    def shuffle_partitions(self) -> int:
        """Reduce partitions of a hash exchange (a grouped aggregate's)."""
        return int(self._get(SHUFFLE_PARTITIONS))
