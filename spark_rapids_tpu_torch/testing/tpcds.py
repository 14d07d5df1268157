"""TPC-DS store_sales, date_dim and item generation, and q3, without JAX.

A copy of the pure-Python parts of ``spark_rapids_tpu/testing/tpcds.py``
(``STORE_SALES_SCHEMA`` :21, ``DATE_DIM_SCHEMA`` :38, ``ITEM_SCHEMA`` :48,
``gen_date_dim`` :61, ``gen_item`` :79, ``gen_store_sales`` :102 with
``_gen_channel_fact`` :206, ``q3`` :134).  Generation draws the same numpy
streams in the same order as the reference, so both packages see the same
tables for a seed.  The fact table is made in chunks of ``batch_rows``
rows and chunk c reseeds with ``seed + 31 * c``, so its data depends on
``batch_rows``.  ``iter_store_sales`` yields host numpy columns and
``store_sales_batches`` uploads them; the dimensions come as one device
batch each.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.arrow import batch_from_numpy
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema

STORE_SALES_SCHEMA = Schema.of(
    ss_sold_date_sk=T.INT,
    ss_item_sk=T.INT,
    ss_customer_sk=T.INT,
    ss_store_sk=T.INT,
    ss_quantity=T.INT,
    ss_ext_sales_price=T.DOUBLE,
    ss_net_profit=T.DOUBLE,
    ss_ticket_number=T.INT,
    ss_cdemo_sk=T.INT,
    ss_hdemo_sk=T.INT,
    ss_promo_sk=T.INT,
    ss_sold_time_sk=T.INT,
)

DATE_DIM_SCHEMA = Schema.of(
    d_date_sk=T.INT,
    d_year=T.INT,
    d_moy=T.INT,
    d_day_name=T.STRING,
    d_week_seq=T.INT,
    d_date_ord=T.INT,
    d_dom=T.INT,
)

ITEM_SCHEMA = Schema.of(
    i_item_sk=T.INT,
    i_brand_id=T.INT,
    i_brand=T.STRING,
    i_manufact_id=T.INT,
    i_category_id=T.INT,
    i_category=T.STRING,
    i_manager_id=T.INT,
    i_item_id=T.STRING,
    i_item_desc=T.STRING,
)

# TPC-DS row counts at scale factor 10 (the specification's table 3-2)
SF10_STORE_SALES_ROWS = 28_800_991
SF10_ITEM_ROWS = 102_000

Columns = Dict[str, np.ndarray]


def gen_date_dim(device) -> ColumnarBatch:
    """One row per day 1998-2003 (like the real dim's surrogate keys)."""
    n = 6 * 365
    sk = np.arange(2450000, 2450000 + n, dtype=np.int32)
    year = 1998 + (np.arange(n) // 365)
    moy = 1 + (np.arange(n) % 365) // 31
    day_names = ["Sunday", "Monday", "Tuesday", "Wednesday", "Thursday",
                 "Friday", "Saturday"]
    return ColumnarBatch.from_pydict(
        {"d_date_sk": sk.tolist(), "d_year": year.tolist(),
         "d_moy": np.minimum(moy, 12).tolist(),
         "d_day_name": [day_names[i % 7] for i in range(n)],
         "d_week_seq": (np.arange(n) // 7).tolist(),
         "d_date_ord": list(range(n)),
         "d_dom": (1 + np.arange(n) % 28).tolist()},
        DATE_DIM_SCHEMA, device)


def gen_item(device, n_items: int = 2000, seed: int = 11) -> ColumnarBatch:
    rng = np.random.RandomState(seed)
    cats = ["Home", "Books", "Electronics", "Jewelry", "Music", "Shoes",
            "Sports", "Women", "Men", "Children", "Hobbies"]
    brand_id = rng.randint(1, 100, n_items)
    manu_id = rng.randint(1, 120, n_items)
    cat_id = rng.randint(1, 12, n_items)
    manager_id = rng.randint(1, 100, n_items)
    words = ["alpha", "bright", "classic", "durable", "elegant", "fresh"]
    return ColumnarBatch.from_pydict(
        {"i_item_sk": list(range(1, n_items + 1)),
         "i_brand_id": brand_id.tolist(),
         "i_brand": [f"Brand#{b}{m % 10}" for b, m in zip(brand_id, manu_id)],
         "i_manufact_id": manu_id.tolist(),
         "i_category_id": cat_id.tolist(),
         "i_category": [cats[(c - 1) % 11] for c in cat_id],
         "i_manager_id": manager_id.tolist(),
         "i_item_id": [f"AAAAAAAA{k:08d}" for k in range(1, n_items + 1)],
         "i_item_desc": [f"{words[k % 6]} {words[(k * 7) % 6]} item {k}"
                         for k in range(1, n_items + 1)]},
        ITEM_SCHEMA, device)


def _store_sales_spec(rng, n: int, n_rows: int, n_items: int
                      ) -> Tuple[Columns, Columns]:
    data = {
        "ss_sold_date_sk": (2450000 + rng.randint(0, 6 * 365, n)
                            ).astype(np.int32),
        "ss_item_sk": (1 + rng.randint(0, n_items, n)).astype(np.int32),
        "ss_customer_sk": (1 + rng.randint(0, 50_000, n)).astype(np.int32),
        "ss_store_sk": (1 + rng.randint(0, 50, n)).astype(np.int32),
        "ss_quantity": rng.randint(1, 100, n).astype(np.int32),
        "ss_ext_sales_price": np.round(rng.uniform(1.0, 300.0, n), 2),
        "ss_net_profit": np.round(rng.uniform(-100.0, 200.0, n), 2),
    }
    # a few percent null fact keys, as in real data
    null_mask = rng.rand(n) < 0.02
    validity = {"ss_customer_sk": ~null_mask}
    data["ss_ticket_number"] = (1 + rng.randint(0, max(n_rows // 4, 1), n)
                                ).astype(np.int32)
    data["ss_cdemo_sk"] = (1 + rng.randint(0, 1000, n)).astype(np.int32)
    data["ss_hdemo_sk"] = (1 + rng.randint(0, 100, n)).astype(np.int32)
    data["ss_promo_sk"] = (1 + rng.randint(0, 300, n)).astype(np.int32)
    data["ss_sold_time_sk"] = rng.randint(0, 86400, n).astype(np.int32)
    validity["ss_promo_sk"] = rng.rand(n) >= 0.1   # some null promos
    return data, validity


def iter_store_sales(n_rows: int, n_items: int = 2000, seed: int = 13,
                     batch_rows: int = 1 << 19
                     ) -> Iterator[Tuple[Columns, Columns]]:
    """store_sales chunks of at most batch_rows rows: (numpy columns,
    {column: validity} of the columns with nulls); chunk c draws from
    ``RandomState(seed + 31 * c)``, as ``_gen_channel_fact`` does."""
    remaining = n_rows
    chunk = 0
    while remaining > 0:
        n = min(batch_rows, remaining)
        rng = np.random.RandomState(seed + 31 * chunk)
        yield _store_sales_spec(rng, n, n_rows, n_items)
        remaining -= n
        chunk += 1


def store_sales_batch(data: Columns, validity: Columns,
                      device) -> ColumnarBatch:
    return batch_from_numpy(
        {k: (v, validity[k]) if k in validity else v for k, v in data.items()},
        STORE_SALES_SCHEMA, device)


def store_sales_batches(n_rows: int, device, n_items: int = 2000,
                        seed: int = 13, batch_rows: int = 1 << 19
                        ) -> List[ColumnarBatch]:
    return [store_sales_batch(d, v, device)
            for d, v in iter_store_sales(n_rows, n_items, seed, batch_rows)]


def q3(store_sales_df, date_dim_df, item_df):
    """TPC-DS Q3 shape: fact x date_dim x item, filter, group, agg, sort.

    select d_year, i_brand_id, i_brand, sum(ss_ext_sales_price) sum_agg
    from store_sales join date_dim on ss_sold_date_sk = d_date_sk
                     join item on ss_item_sk = i_item_sk
    where i_manufact_id = 28 and d_moy = 11
    group by d_year, i_brand_id, i_brand
    order by d_year, sum_agg desc, i_brand_id
    """
    from spark_rapids_tpu_torch.expressions import col, lit, sum_
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    joined = (store_sales_df
              .join(date_dim_df, on=([col("ss_sold_date_sk")],
                                     [col("d_date_sk")]))
              .join(item_df, on=([col("ss_item_sk")], [col("i_item_sk")])))
    return (joined
            .filter((col("i_manufact_id") == lit(28))
                    & (col("d_moy") == lit(11)))
            .group_by("d_year", "i_brand_id", "i_brand")
            .agg(sum_("ss_ext_sales_price").alias("sum_agg"))
            .order_by(("d_year", SortOrder(True)),
                      ("sum_agg", SortOrder(False)),
                      ("i_brand_id", SortOrder(True))))
