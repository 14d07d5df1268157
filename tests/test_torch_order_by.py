"""ORDER BY over signed zeros: a property of the reference that the port
follows, pinned in both JAX modes and the port.

The JAX device path sorts doubles by ``f64_total_order_u64``
(``spark_rapids_tpu/kernels/sort.py:52``), which puts -0.0 strictly below
0.0; its CPU oracle, like Spark's ``SQLOrderingUtil.compareDoubles``,
counts them equal, so the next key decides.  The port gives the device
path's rows (ROADMAP queue 3).  Rows compare with their zeros' signs.
"""
import math

import pytest

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.api.session import TpuSession
from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.columnar.batch import Schema as JaxSchema
from spark_rapids_tpu.kernels.sort import SortOrder as JaxSortOrder

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.kernels.sort import SortOrder

DATA = {"d": [0.0, -0.0, 0.0, -0.0], "k": [1, 2, 3, 4]}
P0, N0 = 0.0, -0.0
# (ascending on d): rows as (d, k)
ORACLE = {True: [(P0, 1), (N0, 2), (P0, 3), (N0, 4)],
          False: [(P0, 1), (N0, 2), (P0, 3), (N0, 4)]}
DEVICE = {True: [(N0, 2), (N0, 4), (P0, 1), (P0, 3)],
          False: [(P0, 1), (P0, 3), (N0, 2), (N0, 4)]}


def signed(rows):
    return [(math.copysign(1.0, d), d, k) for d, k in rows]


def jax_rows(enabled: bool, asc: bool):
    df = TpuSession({"spark.rapids.sql.enabled": str(enabled).lower()}
                    ).create_dataframe([JaxBatch.from_pydict(
                        DATA, JaxSchema(("d", "k"), (JT.DOUBLE, JT.INT)))])
    return df.order_by(("d", JaxSortOrder(asc)),
                       ("k", JaxSortOrder(True))).collect()


@pytest.mark.parametrize("asc", [True, False], ids=["asc", "desc"])
def test_signed_zero_order_by_is_pinned_to_the_reference(asc):
    assert signed(jax_rows(False, asc)) == signed(ORACLE[asc])
    assert signed(jax_rows(True, asc)) == signed(DEVICE[asc])
    df = GpuSession(device="cpu").create_dataframe([ColumnarBatch.from_pydict(
        DATA, Schema(("d", "k"), (T.DOUBLE, T.INT)), "cpu")])
    got = df.order_by(("d", SortOrder(asc)), ("k", SortOrder(True))).collect()
    assert signed(got) == signed(DEVICE[asc])
