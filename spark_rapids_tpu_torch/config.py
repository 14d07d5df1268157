"""Session configuration of the port.

Counterpart of ``spark_rapids_tpu/config.py`` (``RapidsConf`` :927), cut to
the keys the q6, q1, q3, q25 and q72 paths read, and ``fuseStages``
(``STAGE_FUSION`` :150-156, ``fuse_stages`` :1109).  Keys keep the
reference's names; a key the port does not know is kept and ignored, as
Spark does with unknown confs.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

SQL_ENABLED = "spark.rapids.sql.enabled"
BATCH_SIZE_ROWS = "spark.rapids.sql.batchSizeRows"
SHUFFLE_PARTITIONS = "spark.sql.shuffle.partitions"
BROADCAST_ROW_THRESHOLD = "spark.rapids.sql.join.broadcastRowThreshold"
JOIN_ADAPTIVE = "spark.rapids.sql.join.adaptive.enabled"
AQE_COALESCE = "spark.rapids.sql.adaptive.coalescePartitions.enabled"
BATCH_SIZE_BYTES = "spark.rapids.sql.batchSizeBytes"
STAGE_FUSION = "spark.rapids.sql.tpu.fuseStages"

_DEFAULTS = {
    SQL_ENABLED: True,
    # config.py:145-148 of the reference
    BATCH_SIZE_ROWS: 1 << 20,
    # config.py:184 of the reference
    SHUFFLE_PARTITIONS: 16,
    # config.py:258 of the reference
    BROADCAST_ROW_THRESHOLD: 500_000,
    # config.py:265, :200 and :140 of the reference
    JOIN_ADAPTIVE: True,
    AQE_COALESCE: True,
    BATCH_SIZE_BYTES: 1 << 28,
    # config.py:150-156 of the reference
    STAGE_FUSION: True,
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
        if self.batch_size_bytes < 1:
            raise ValueError(
                f"{BATCH_SIZE_BYTES} must be >= 1, got {self.batch_size_bytes}")
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

    @property
    def broadcast_row_threshold(self) -> int:
        """Estimated build-side rows at or below which a join plans as a
        broadcast hash join."""
        return int(self._get(BROADCAST_ROW_THRESHOLD))

    @property
    def join_adaptive_enabled(self) -> bool:
        """A join whose build estimate lies above the broadcast threshold
        but within 8x of it decides broadcast or shuffled at run time."""
        return _to_bool(self._get(JOIN_ADAPTIVE))

    @property
    def aqe_coalesce_partitions(self) -> bool:
        """Hash exchanges under a final aggregate or a shuffled join are
        read through a coalesced reader."""
        return _to_bool(self._get(AQE_COALESCE))

    @property
    def batch_size_bytes(self) -> int:
        """The coalesced reader's byte goal, turned into a row cap from
        the estimated row width."""
        return int(self._get(BATCH_SIZE_BYTES))

    @property
    def fuse_stages(self) -> bool:
        """Run each exchange-free chain of Project / Filter / partial
        aggregate as one fused-segment kernel per batch (plan/fused.py)."""
        return _to_bool(self._get(STAGE_FUSION))
