"""The held aggregate shapes: the table and queries of the reference's
``tests/test_queries.py`` (``SCHEMA`` :101, ``make_data`` :104-121,
``test_global_aggregate`` :149, ``test_grouped_aggregate`` :163) and
``tests/test_variance.py`` (:6, :14), at any size, without JAX.

No TPC query over the repo's generators runs MIN or MAX, so these shapes
are the main path of the port's extremes: ``k`` INT (13 keys), ``v``
LONG, ``x`` DOUBLE (NaN, +inf and -0.0 at rows 0-2), ``f`` FLOAT, ``b``
BOOLEAN, each with n // 7 nulls.  ``columns`` draws the numpy streams of
``make_data`` in its order, vectorised, so ``columns(500, 0)`` is
``make_data()`` row for row.

Each query takes the dataframe and the DSL module to build it with (the
port's by default): the same function builds the JAX package's twin in
the CPU tests.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from spark_rapids_tpu_torch import expressions as PE
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batch_from_numpy
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema

SCHEMA = Schema.of(k=T.INT, v=T.LONG, x=T.DOUBLE, f=T.FLOAT, b=T.BOOLEAN)
NKEYS = 13


def columns(n: int, seed: int = 0
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(values, validity) per column; a null slot holds zero."""
    rng = np.random.RandomState(seed)
    data = {
        "k": rng.randint(0, NKEYS, n).astype(np.int32),
        "v": rng.randint(-10**9, 10**9, n).astype(np.int64),
        "x": rng.randn(n),
        "f": rng.randn(n).astype(np.float32),
        "b": rng.rand(n) > 0.5,
    }
    data["x"][:3] = [np.nan, np.inf, -0.0][:n]
    validity = {}
    for name in SCHEMA.names:
        ok = np.ones(n, np.bool_)
        ok[rng.choice(n, size=n // 7, replace=False)] = False
        validity[name] = ok
        data[name] = np.where(ok, data[name], np.zeros((), data[name].dtype))
    return data, validity


def batches(n: int, device, seed: int = 0, batch_rows: int = 1 << 20
            ) -> List[ColumnarBatch]:
    data, validity = columns(n, seed)
    return [batch_from_numpy({c: (data[c][o:o + batch_rows],
                                  validity[c][o:o + batch_rows])
                              for c in SCHEMA.names}, SCHEMA, device)
            for o in range(0, n, batch_rows)]


def extreme_aggs(E, cols: str) -> list:
    return [f(c).alias(f"{f.__name__}_{c}") for c in cols
            for f in (E.min_, E.max_)]


def variance_aggs(E, cols: str) -> list:
    return [f(c).alias(f"{f.__name__}_{c}") for c in cols
            for f in (E.var_samp, E.var_pop, E.stddev, E.stddev_pop)]


def global_aggregate(df, E=PE):
    """test_global_aggregate (:149)."""
    return df.agg(E.sum_("v").alias("sv"), E.count("v").alias("cv"),
                  E.count().alias("cs"), E.min_("v").alias("mn"),
                  E.max_("v").alias("mx"), E.avg("x").alias("ax"))


def grouped_aggregate(df, E=PE):
    """test_grouped_aggregate (:163)."""
    return df.group_by("k").agg(
        E.sum_("v").alias("sv"), E.count("v").alias("cv"),
        E.min_("x").alias("mn"), E.max_("x").alias("mx"),
        E.avg("v").alias("av"))


def global_extremes(df, E=PE):
    """MIN and MAX of all five columns."""
    return df.agg(*extreme_aggs(E, "kvxfb"))


def grouped_extremes(df, E=PE):
    return df.group_by("k").agg(*extreme_aggs(E, "vxfb"))


def global_variance(df, E=PE):
    """test_variance.py :6 over ``x`` and, as :14 does, ``v``."""
    return df.agg(*variance_aggs(E, "xv"))


def grouped_variance(df, E=PE):
    return df.group_by("k").agg(*variance_aggs(E, "xv"))


def filtered_global(df, E=PE):
    """A global MIN / MAX / M2 after a filter: one fused segment."""
    return df.filter(E.col("v") > E.lit(0)).agg(
        *extreme_aggs(E, "kxfb"), E.var_samp("v").alias("var_samp_v"),
        E.stddev_pop("x").alias("stddev_pop_x"))


QUERIES = {f.__name__: f for f in (
    global_aggregate, grouped_aggregate, global_extremes, grouped_extremes,
    global_variance, grouped_variance, filtered_global)}
