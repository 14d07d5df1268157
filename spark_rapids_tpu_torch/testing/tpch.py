"""TPC-H lineitem generation, q6 and q1, without JAX.

A copy of the pure-Python parts of ``spark_rapids_tpu/testing/tpch.py``
(``LINEITEM_SCHEMA`` :39, ``ROWS_PER_SF`` :54, ``gen_lineitem`` :57,
``q6`` :106, ``q1`` :129).  Generation draws the same numpy streams in the same order as
the reference, so both packages see identical data for a seed; it returns
host numpy columns, and ``lineitem_batches`` uploads them.
"""
from __future__ import annotations

import datetime
from typing import Dict, Iterator, List

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batch_from_numpy
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema

EPOCH = datetime.date(1970, 1, 1)


def _days(y, m, d) -> int:
    return (datetime.date(y, m, d) - EPOCH).days


# money and quantity columns are decimal(12,2), the official TPC-H schema
DEC12_2 = T.DecimalType(12, 2)

LINEITEM_SCHEMA = Schema.of(
    l_orderkey=T.LONG,
    l_partkey=T.LONG,
    l_suppkey=T.LONG,
    l_linenumber=T.INT,
    l_quantity=DEC12_2,
    l_extendedprice=DEC12_2,
    l_discount=DEC12_2,
    l_tax=DEC12_2,
    l_shipdate=T.DATE,
    l_commitdate=T.DATE,
    l_receiptdate=T.DATE,
)

# TPC-H SF1 lineitem is ~6M rows
ROWS_PER_SF = 6_001_215


def iter_lineitem(num_rows: int, seed: int = 42,
                  batch_rows: int = 1 << 20) -> Iterator[Dict[str, np.ndarray]]:
    """Lineitem chunks of at most batch_rows rows, as numpy columns
    (decimals as int64 unscaled values, dates as int32 days)."""
    remaining = num_rows
    chunk_id = 0
    while remaining > 0:
        n = min(batch_rows, remaining)
        rng = np.random.RandomState(seed + chunk_id * 7919)
        orderkey = rng.randint(1, max(num_rows // 4, 2), n).astype(np.int64)
        partkey = rng.randint(1, 200_000, n).astype(np.int64)
        suppkey = rng.randint(1, 10_000, n).astype(np.int64)
        linenumber = rng.randint(1, 8, n).astype(np.int32)
        quantity = (rng.randint(1, 51, n) * 100).astype(np.int64)
        extendedprice = np.round(
            rng.uniform(900.0, 105_000.0, n) * 100).astype(np.int64)
        discount = rng.randint(0, 11, n).astype(np.int64)
        tax = rng.randint(0, 9, n).astype(np.int64)
        ship_lo, ship_hi = _days(1992, 1, 2), _days(1998, 12, 1)
        shipdate = rng.randint(ship_lo, ship_hi, n).astype(np.int32)
        commitdate = shipdate + rng.randint(-30, 31, n).astype(np.int32)
        receiptdate = shipdate + rng.randint(1, 31, n).astype(np.int32)
        yield {
            "l_orderkey": orderkey,
            "l_partkey": partkey,
            "l_suppkey": suppkey,
            "l_linenumber": linenumber,
            "l_quantity": quantity,
            "l_extendedprice": extendedprice,
            "l_discount": discount,
            "l_tax": tax,
            "l_shipdate": shipdate,
            "l_commitdate": commitdate,
            "l_receiptdate": receiptdate,
        }
        remaining -= n
        chunk_id += 1


def gen_lineitem(num_rows: int, seed: int = 42,
                 batch_rows: int = 1 << 20) -> List[Dict[str, np.ndarray]]:
    return list(iter_lineitem(num_rows, seed, batch_rows))


def lineitem_batches(num_rows: int, device, seed: int = 42,
                     batch_rows: int = 1 << 20) -> List[ColumnarBatch]:
    return [batch_from_numpy(c, LINEITEM_SCHEMA, device)
            for c in iter_lineitem(num_rows, seed, batch_rows)]


def _q6_filter(df):
    from spark_rapids_tpu_torch.expressions import col, lit
    return df.filter(
        (col("l_shipdate") >= lit(_days(1994, 1, 1), T.DATE))
        & (col("l_shipdate") < lit(_days(1995, 1, 1), T.DATE))
        & (col("l_discount") >= lit(5, DEC12_2))
        & (col("l_discount") <= lit(7, DEC12_2))
        & (col("l_quantity") < lit(2400, DEC12_2)))


def _revenue():
    from spark_rapids_tpu_torch.expressions import Cast, col, sum_
    price = Cast(col("l_extendedprice"), T.DOUBLE)
    disc = Cast(col("l_discount"), T.DOUBLE)
    return sum_(price * disc).alias("revenue")


def q6(df):
    """TPC-H Q6: forecast revenue change.

    select sum(l_extendedprice * l_discount) as revenue from lineitem
    where l_shipdate >= '1994-01-01' and l_shipdate < '1995-01-01'
      and l_discount between 0.05 and 0.07 and l_quantity < 24
    """
    return _q6_filter(df).agg(_revenue())


def q6_count(df):
    """q6 with count(*) of the qualifying rows beside the revenue."""
    from spark_rapids_tpu_torch.expressions import count
    return _q6_filter(df).agg(_revenue(), count().alias("n"))


def q1(df):
    """TPC-H Q1: pricing summary report (scan + filter + wide group-agg),
    written as the reference's; l_linenumber stands in for the
    returnflag/linestatus keys until strings land."""
    from spark_rapids_tpu_torch.expressions import Cast, avg, col, count, lit, sum_
    cutoff = _days(1998, 9, 2)
    qty = Cast(col("l_quantity"), T.DOUBLE)
    price = Cast(col("l_extendedprice"), T.DOUBLE)
    disc = Cast(col("l_discount"), T.DOUBLE)
    tax = Cast(col("l_tax"), T.DOUBLE)
    disc_price = price * (lit(1.0) - disc)
    charge = disc_price * (lit(1.0) + tax)
    return (df.filter(col("l_shipdate") <= lit(cutoff, T.DATE))
            .group_by("l_linenumber")
            .agg(sum_(qty).alias("sum_qty"),
                 sum_(price).alias("sum_base_price"),
                 sum_(disc_price).alias("sum_disc_price"),
                 sum_(charge).alias("sum_charge"),
                 avg(qty).alias("avg_qty"),
                 avg(price).alias("avg_price"),
                 avg(disc).alias("avg_disc"),
                 count().alias("count_order")))
