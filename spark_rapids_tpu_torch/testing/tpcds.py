"""TPC-DS generation (store_sales, store_returns, catalog_sales,
catalog_returns, inventory, date_dim, time_dim, item, store, warehouse,
promotion, customer, customer_address, customer_demographics,
household_demographics, and the channel sales and returns of q5 and q14a)
and q3, q5, q7, q14a, q17, q19, q25, q26, q42, q52, q55, q72, q96 and q98
(with the q5 and q14a subsets), without JAX.

A copy of the pure-Python parts of ``spark_rapids_tpu/testing/tpcds.py``
(``STORE_SALES_SCHEMA`` :21, ``DATE_DIM_SCHEMA`` :38, ``ITEM_SCHEMA`` :48,
``STORE_RETURNS_SCHEMA`` :381, ``CATALOG_SALES_SCHEMA`` :391,
``CATALOG_RETURNS_SCHEMA`` :405, ``INVENTORY_SCHEMA`` :411,
``WAREHOUSE_SCHEMA`` :418, ``STORE_SCHEMA`` :423, ``PROMOTION_SCHEMA``
:430, ``CUSTOMER_SCHEMA`` :436, ``CUSTOMER_ADDRESS_SCHEMA`` :442,
``CUSTOMER_DEMOGRAPHICS_SCHEMA`` :448,
``HOUSEHOLD_DEMOGRAPHICS_SCHEMA`` :455, ``TIME_DIM_SCHEMA`` :461,
``gen_date_dim`` :61,
``gen_item`` :79, ``gen_store_sales`` :102 with ``_gen_channel_fact``
:206, ``host_pool`` :468, ``gen_store_returns`` :483,
``gen_catalog_sales`` :525, ``gen_catalog_returns`` :575,
``gen_inventory`` :601, ``gen_warehouse`` :618, ``gen_store`` :625,
``gen_promotion`` :637, ``gen_customer`` :647,
``gen_customer_address`` :657, ``gen_customer_demographics`` :669,
``gen_household_demographics`` :681, ``gen_time_dim`` :691,
``CHANNEL_SALES_SCHEMA`` :188,
``CHANNEL_RETURNS_SCHEMA`` :197, ``gen_channel_sales`` :232,
``gen_channel_returns`` :251, ``_aliased`` :701, ``q3`` :134,
``q5_subset`` :158, ``q14a_subset`` :171, ``q5`` :268, ``q14a`` :315,
``q7`` :709, ``q19`` :733, ``q25`` :758, ``q26`` :794, ``q42`` :817,
``q52`` :835, ``q55`` :852, ``q72`` :868, ``q96`` :913).  Generation draws the same numpy streams in
the same order as the reference, so both packages see the same tables for
a seed.  A fact table is made in chunks of ``batch_rows`` rows and chunk c
reseeds with ``seed + stride * c`` (stride 31 for store_sales, 43 for
store_returns, 53 for catalog_sales, 61 for catalog_returns, 71 for
inventory, 131 for channel sales, 137 for channel returns), so its data
depends on ``batch_rows``.  The ``iter_*``
functions yield host numpy columns and the ``*_batches`` ones upload them;
the dimensions come as one device batch each.

The correlated facts draw from a pool of an earlier fact's rows
(``host_pool``): store_returns copies (ticket, item, customer, sale date)
from store_sales, catalog_sales copies (customer, item, return date) from
store_returns.  The reference reads its pool back from the device, where
a null slot holds 0, so ``host_pool`` zeroes the null slots of the host
chunks it is given: about 2% of the matched returns carry
``sr_customer_sk = 0``.
"""
from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Optional, Tuple

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

STORE_RETURNS_SCHEMA = Schema.of(
    sr_returned_date_sk=T.INT,
    sr_item_sk=T.INT,
    sr_customer_sk=T.INT,
    sr_ticket_number=T.INT,
    sr_return_quantity=T.INT,
    sr_return_amt=T.DOUBLE,
    sr_net_loss=T.DOUBLE,
)

CATALOG_SALES_SCHEMA = Schema.of(
    cs_sold_date_sk=T.INT,
    cs_ship_date_sk=T.INT,
    cs_item_sk=T.INT,
    cs_bill_customer_sk=T.INT,
    cs_bill_cdemo_sk=T.INT,
    cs_bill_hdemo_sk=T.INT,
    cs_promo_sk=T.INT,
    cs_order_number=T.INT,
    cs_quantity=T.INT,
    cs_ext_sales_price=T.DOUBLE,
    cs_net_profit=T.DOUBLE,
)

CATALOG_RETURNS_SCHEMA = Schema.of(
    cr_item_sk=T.INT,
    cr_order_number=T.INT,
    cr_return_quantity=T.INT,
)

INVENTORY_SCHEMA = Schema.of(
    inv_date_sk=T.INT,
    inv_item_sk=T.INT,
    inv_warehouse_sk=T.INT,
    inv_quantity_on_hand=T.INT,
)

WAREHOUSE_SCHEMA = Schema.of(
    w_warehouse_sk=T.INT,
    w_warehouse_name=T.STRING,
)

STORE_SCHEMA = Schema.of(
    s_store_sk=T.INT,
    s_store_id=T.STRING,
    s_store_name=T.STRING,
    s_zip=T.STRING,
)

PROMOTION_SCHEMA = Schema.of(
    p_promo_sk=T.INT,
    p_channel_email=T.STRING,
    p_channel_event=T.STRING,
)

CUSTOMER_DEMOGRAPHICS_SCHEMA = Schema.of(
    cd_demo_sk=T.INT,
    cd_gender=T.STRING,
    cd_marital_status=T.STRING,
    cd_education_status=T.STRING,
)

HOUSEHOLD_DEMOGRAPHICS_SCHEMA = Schema.of(
    hd_demo_sk=T.INT,
    hd_buy_potential=T.STRING,
    hd_dep_count=T.INT,
)

CUSTOMER_SCHEMA = Schema.of(
    c_customer_sk=T.INT,
    c_current_addr_sk=T.INT,
    c_birth_month=T.INT,
)

CUSTOMER_ADDRESS_SCHEMA = Schema.of(
    ca_address_sk=T.INT,
    ca_city=T.STRING,
    ca_zip=T.STRING,
)

TIME_DIM_SCHEMA = Schema.of(
    t_time_sk=T.INT,
    t_hour=T.INT,
    t_minute=T.INT,
)

# TPC-DS row counts at scale factor 10 (the specification's table 3-2)
SF10_STORE_SALES_ROWS = 28_800_991
SF10_STORE_RETURNS_ROWS = 2_875_432
SF10_CATALOG_SALES_ROWS = 14_401_261
SF10_CATALOG_RETURNS_ROWS = 1_439_749
SF10_INVENTORY_ROWS = 133_110_000
SF10_WEB_SALES_ROWS = 7_197_566
SF10_WEB_RETURNS_ROWS = 719_217
SF10_ITEM_ROWS = 102_000
SF10_WAREHOUSE_ROWS = 10

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


def _iter_fact(spec, n_rows: int, seed: int, stride: int, batch_rows: int
               ) -> Iterator[Tuple[Columns, Columns]]:
    """Chunks of at most batch_rows rows: (numpy columns, {column:
    validity} of the columns with nulls); chunk c draws ``spec(rng, n)``
    from ``RandomState(seed + stride * c)``, as ``_gen_channel_fact``
    does."""
    remaining = n_rows
    chunk = 0
    while remaining > 0:
        n = min(batch_rows, remaining)
        out = spec(np.random.RandomState(seed + stride * chunk), n)
        yield out if isinstance(out, tuple) else (out, {})
        remaining -= n
        chunk += 1


def iter_store_sales(n_rows: int, n_items: int = 2000, seed: int = 13,
                     batch_rows: int = 1 << 19
                     ) -> Iterator[Tuple[Columns, Columns]]:
    """store_sales chunks (stride 31)."""
    return _iter_fact(lambda rng, n: _store_sales_spec(rng, n, n_rows,
                                                       n_items),
                      n_rows, seed, 31, batch_rows)


def fact_batch(data: Columns, validity: Columns, schema: Schema,
               device) -> ColumnarBatch:
    """One host chunk uploaded; null slots are zeroed."""
    return batch_from_numpy(
        {k: (data[k], validity[k]) if k in validity else data[k]
         for k in schema.names}, schema, device)


def store_sales_batch(data: Columns, validity: Columns,
                      device) -> ColumnarBatch:
    return fact_batch(data, validity, STORE_SALES_SCHEMA, device)


def store_sales_batches(n_rows: int, device, n_items: int = 2000,
                        seed: int = 13, batch_rows: int = 1 << 19
                        ) -> List[ColumnarBatch]:
    return [store_sales_batch(d, v, device)
            for d, v in iter_store_sales(n_rows, n_items, seed, batch_rows)]


def host_pool(chunks: Iterable[Tuple[Columns, Columns]], names
              ) -> List[np.ndarray]:
    """The named columns of host chunks, concatenated, each null slot 0 as
    on the device: the pool a correlated fact draws from."""
    cols: Dict[str, List[np.ndarray]] = {n: [] for n in names}
    for data, validity in chunks:
        for n in names:
            v = data[n]
            cols[n].append(np.where(validity[n], v, np.zeros((), v.dtype))
                           if n in validity else v)
    return [np.concatenate(cols[n]) for n in names]


def iter_store_returns(n_rows: int, n_items: int = 2000, seed: int = 41,
                       n_tickets: int = 500_000,
                       pool: Optional[List[np.ndarray]] = None,
                       match_frac: float = 0.8, batch_rows: int = 1 << 19
                       ) -> Iterator[Tuple[Columns, Columns]]:
    """store_returns chunks (stride 43).  ``pool`` is ``host_pool`` of
    store_sales over (ss_ticket_number, ss_item_sk, ss_customer_sk,
    ss_sold_date_sk): match_frac of the rows copy (ticket, item, customer)
    from a sale and are returned 1-59 days after it."""
    def spec(rng, n):
        data = {
            "sr_returned_date_sk": (2450000 + rng.randint(0, 6 * 365, n)
                                    ).astype(np.int32),
            "sr_item_sk": (1 + rng.randint(0, n_items, n)).astype(np.int32),
            "sr_customer_sk": (1 + rng.randint(0, 50_000, n)
                               ).astype(np.int32),
            "sr_ticket_number": (1 + rng.randint(0, n_tickets, n)
                                 ).astype(np.int32),
            "sr_return_quantity": rng.randint(1, 20, n).astype(np.int32),
            "sr_return_amt": np.round(rng.uniform(1.0, 150.0, n), 2),
            "sr_net_loss": np.round(rng.uniform(0.5, 80.0, n), 2),
        }
        if pool is not None and len(pool[0]):
            take = rng.rand(n) < match_frac
            idx = rng.randint(0, len(pool[0]), n)
            for dst, src in (("sr_ticket_number", 0), ("sr_item_sk", 1),
                             ("sr_customer_sk", 2)):
                data[dst] = np.where(take, pool[src][idx],
                                     data[dst]).astype(np.int32)
            data["sr_returned_date_sk"] = np.where(
                take, pool[3][idx] + rng.randint(1, 60, n),
                data["sr_returned_date_sk"]).astype(np.int32)
        return data
    return _iter_fact(spec, n_rows, seed, 43, batch_rows)


def gen_store_returns(n_rows: int, device, n_items: int = 2000,
                      seed: int = 41, n_tickets: int = 500_000,
                      pool: Optional[List[np.ndarray]] = None,
                      match_frac: float = 0.8, batch_rows: int = 1 << 19
                      ) -> List[ColumnarBatch]:
    return [fact_batch(d, v, STORE_RETURNS_SCHEMA, device)
            for d, v in iter_store_returns(n_rows, n_items, seed, n_tickets,
                                           pool, match_frac, batch_rows)]


def iter_catalog_sales(n_rows: int, n_items: int = 2000, seed: int = 47,
                       pair_pool: Optional[List[np.ndarray]] = None,
                       match_frac: float = 0.5, batch_rows: int = 1 << 19
                       ) -> Iterator[Tuple[Columns, Columns]]:
    """catalog_sales chunks (stride 53).  ``pair_pool`` is [customer_sks,
    item_sks] and optionally a date_sk: match_frac of the rows copy a
    (customer, item) pair and are sold 1-59 days after that date."""
    def spec(rng, n):
        sold = 2450000 + rng.randint(0, 6 * 365, n)
        data = {
            "cs_sold_date_sk": sold.astype(np.int32),
            "cs_ship_date_sk": (sold + rng.randint(1, 30, n)
                                ).astype(np.int32),
            "cs_item_sk": (1 + rng.randint(0, n_items, n)).astype(np.int32),
            "cs_bill_customer_sk": (1 + rng.randint(0, 50_000, n)
                                    ).astype(np.int32),
            "cs_bill_cdemo_sk": (1 + rng.randint(0, 1000, n)
                                 ).astype(np.int32),
            "cs_bill_hdemo_sk": (1 + rng.randint(0, 100, n)
                                 ).astype(np.int32),
            "cs_promo_sk": (1 + rng.randint(0, 300, n)).astype(np.int32),
            "cs_order_number": (1 + rng.randint(0, max(n_rows // 3, 1), n)
                                ).astype(np.int32),
            "cs_quantity": rng.randint(1, 100, n).astype(np.int32),
            "cs_ext_sales_price": np.round(rng.uniform(1.0, 300.0, n), 2),
            "cs_net_profit": np.round(rng.uniform(-100.0, 200.0, n), 2),
        }
        validity = {"cs_promo_sk": rng.rand(n) >= 0.15}
        if pair_pool is not None and len(pair_pool[0]):
            take = rng.rand(n) < match_frac
            idx = rng.randint(0, len(pair_pool[0]), n)
            data["cs_bill_customer_sk"] = np.where(
                take, pair_pool[0][idx],
                data["cs_bill_customer_sk"]).astype(np.int32)
            data["cs_item_sk"] = np.where(
                take, pair_pool[1][idx], data["cs_item_sk"]).astype(np.int32)
            if len(pair_pool) > 2:
                new_sold = pair_pool[2][idx] + rng.randint(1, 60, n)
                data["cs_sold_date_sk"] = np.where(
                    take, new_sold,
                    data["cs_sold_date_sk"]).astype(np.int32)
                data["cs_ship_date_sk"] = np.where(
                    take, new_sold + rng.randint(1, 30, n),
                    data["cs_ship_date_sk"]).astype(np.int32)
        return data, validity
    return _iter_fact(spec, n_rows, seed, 53, batch_rows)


def gen_catalog_sales(n_rows: int, device, n_items: int = 2000,
                      seed: int = 47,
                      pair_pool: Optional[List[np.ndarray]] = None,
                      match_frac: float = 0.5, batch_rows: int = 1 << 19
                      ) -> List[ColumnarBatch]:
    return [fact_batch(d, v, CATALOG_SALES_SCHEMA, device)
            for d, v in iter_catalog_sales(n_rows, n_items, seed, pair_pool,
                                           match_frac, batch_rows)]


def iter_catalog_returns(n_rows: int, n_items: int = 2000, seed: int = 59,
                         n_orders: int = 100_000,
                         order_pool: Optional[List[np.ndarray]] = None,
                         match_frac: float = 0.5, batch_rows: int = 1 << 19
                         ) -> Iterator[Tuple[Columns, Columns]]:
    """catalog_returns chunks (stride 61).  ``order_pool`` is ``host_pool``
    of catalog_sales over (cs_item_sk, cs_order_number): match_frac of the
    rows copy an (item, order) pair."""
    def spec(rng, n):
        data = {
            "cr_item_sk": (1 + rng.randint(0, n_items, n)).astype(np.int32),
            "cr_order_number": (1 + rng.randint(0, n_orders, n)
                                ).astype(np.int32),
            "cr_return_quantity": rng.randint(1, 20, n).astype(np.int32),
        }
        if order_pool is not None and len(order_pool[0]):
            take = rng.rand(n) < match_frac
            idx = rng.randint(0, len(order_pool[0]), n)
            data["cr_item_sk"] = np.where(
                take, order_pool[0][idx], data["cr_item_sk"]).astype(np.int32)
            data["cr_order_number"] = np.where(
                take, order_pool[1][idx],
                data["cr_order_number"]).astype(np.int32)
        return data
    return _iter_fact(spec, n_rows, seed, 61, batch_rows)


def gen_catalog_returns(n_rows: int, device, n_items: int = 2000,
                        seed: int = 59, n_orders: int = 100_000,
                        order_pool: Optional[List[np.ndarray]] = None,
                        match_frac: float = 0.5, batch_rows: int = 1 << 19
                        ) -> List[ColumnarBatch]:
    return [fact_batch(d, v, CATALOG_RETURNS_SCHEMA, device)
            for d, v in iter_catalog_returns(n_rows, n_items, seed, n_orders,
                                             order_pool, match_frac,
                                             batch_rows)]


def iter_inventory(n_rows: int, n_items: int = 2000, n_warehouses: int = 10,
                   seed: int = 67, batch_rows: int = 1 << 19
                   ) -> Iterator[Tuple[Columns, Columns]]:
    """inventory chunks (stride 71): weekly snapshots of (item,
    warehouse) stock, the largest TPC-DS table by rows."""
    def spec(rng, n):
        return {
            "inv_date_sk": (2450000 + 7 * rng.randint(0, 312, n)
                            ).astype(np.int32),
            "inv_item_sk": (1 + rng.randint(0, n_items, n)).astype(np.int32),
            "inv_warehouse_sk": (1 + rng.randint(0, n_warehouses, n)
                                 ).astype(np.int32),
            "inv_quantity_on_hand": rng.randint(0, 500, n).astype(np.int32),
        }
    return _iter_fact(spec, n_rows, seed, 71, batch_rows)


def gen_inventory(n_rows: int, device, n_items: int = 2000,
                  n_warehouses: int = 10, seed: int = 67,
                  batch_rows: int = 1 << 19) -> List[ColumnarBatch]:
    return [fact_batch(d, v, INVENTORY_SCHEMA, device)
            for d, v in iter_inventory(n_rows, n_items, n_warehouses, seed,
                                       batch_rows)]


def gen_warehouse(device, n: int = 10) -> ColumnarBatch:
    return ColumnarBatch.from_pydict(
        {"w_warehouse_sk": list(range(1, n + 1)),
         "w_warehouse_name": [f"Warehouse no {i}" for i in range(1, n + 1)]},
        WAREHOUSE_SCHEMA, device)


def gen_promotion(device, n: int = 300, seed: int = 79) -> ColumnarBatch:
    rng = np.random.RandomState(seed)

    def yn(p):
        return ["Y" if x < p else "N" for x in rng.rand(n)]
    return ColumnarBatch.from_pydict(
        {"p_promo_sk": list(range(1, n + 1)),
         "p_channel_email": yn(0.5),
         "p_channel_event": yn(0.5)},
        PROMOTION_SCHEMA, device)


def gen_customer_demographics(device, n: int = 1000) -> ColumnarBatch:
    ms = ["M", "S", "D", "W", "U"]
    ed = ["Primary", "Secondary", "College", "2 yr Degree", "4 yr Degree",
          "Advanced Degree", "Unknown"]
    return ColumnarBatch.from_pydict(
        {"cd_demo_sk": list(range(1, n + 1)),
         "cd_gender": ["M" if i % 2 else "F" for i in range(n)],
         "cd_marital_status": [ms[i % 5] for i in range(n)],
         "cd_education_status": [ed[i % 7] for i in range(n)]},
        CUSTOMER_DEMOGRAPHICS_SCHEMA, device)


def gen_household_demographics(device, n: int = 100) -> ColumnarBatch:
    pots = [">10000", "5001-10000", "1001-5000", "501-1000", "0-500",
            "Unknown"]
    return ColumnarBatch.from_pydict(
        {"hd_demo_sk": list(range(1, n + 1)),
         "hd_buy_potential": [pots[i % 6] for i in range(n)],
         "hd_dep_count": [i % 10 for i in range(n)]},
        HOUSEHOLD_DEMOGRAPHICS_SCHEMA, device)


def gen_customer(device, n: int = 50_000, seed: int = 83,
                 n_addr: int = 25_000) -> ColumnarBatch:
    rng = np.random.RandomState(seed)
    return ColumnarBatch.from_pydict(
        {"c_customer_sk": list(range(1, n + 1)),
         "c_current_addr_sk": (1 + rng.randint(0, n_addr, n)).tolist(),
         "c_birth_month": (1 + rng.randint(0, 12, n)).tolist()},
        CUSTOMER_SCHEMA, device)


def gen_customer_address(device, n: int = 25_000,
                         seed: int = 89) -> ColumnarBatch:
    rng = np.random.RandomState(seed)
    cities = ["Midway", "Fairview", "Oakland", "Five Points", "Liberty",
              "Greenville", "Bethel", "Pleasant Hill"]
    return ColumnarBatch.from_pydict(
        {"ca_address_sk": list(range(1, n + 1)),
         "ca_city": [cities[int(x) % 8] for x in rng.randint(0, 64, n)],
         "ca_zip": [f"{10000 + int(z):05d}"
                    for z in rng.randint(0, 400, n)]},
        CUSTOMER_ADDRESS_SCHEMA, device)


def gen_time_dim(device) -> ColumnarBatch:
    """One row per second of the day."""
    n = 86400
    return ColumnarBatch.from_pydict(
        {"t_time_sk": list(range(n)),
         "t_hour": (np.arange(n) // 3600).tolist(),
         "t_minute": ((np.arange(n) % 3600) // 60).tolist()},
        TIME_DIM_SCHEMA, device)


def gen_store(device, n: int = 50, seed: int = 73) -> ColumnarBatch:
    rng = np.random.RandomState(seed)
    return ColumnarBatch.from_pydict(
        {"s_store_sk": list(range(1, n + 1)),
         "s_store_id": [f"AAAAAAAA{i:04d}" for i in range(1, n + 1)],
         "s_store_name": [["ought", "able", "pri", "ese", "anti"][i % 5]
                          for i in range(n)],
         "s_zip": [f"{10000 + int(z):05d}"
                   for z in rng.randint(0, 400, n)]},
        STORE_SCHEMA, device)


# -- multi-channel tables (q5 and q14a) ------------------------------------

CHANNEL_SALES_SCHEMA = Schema.of(
    cs_sold_date_sk=T.INT,
    cs_item_sk=T.INT,
    cs_channel_sk=T.INT,       # store_sk / catalog_page_sk / web_site_sk
    cs_quantity=T.INT,
    cs_ext_sales_price=T.DOUBLE,
    cs_net_profit=T.DOUBLE,
)

CHANNEL_RETURNS_SCHEMA = Schema.of(
    cr_returned_date_sk=T.INT,
    cr_item_sk=T.INT,
    cr_channel_sk=T.INT,
    cr_return_amount=T.DOUBLE,
    cr_net_loss=T.DOUBLE,
)


def iter_channel_sales(n_rows: int, n_items: int = 2000, seed: int = 17,
                       n_channel: int = 50, batch_rows: int = 1 << 19
                       ) -> Iterator[Tuple[Columns, Columns]]:
    """Sales chunks of one channel (stride 131); catalog and web have the
    store channel's shape."""
    def spec(rng, n):
        return {
            "cs_sold_date_sk": (2450000 + rng.randint(0, 6 * 365, n)
                                ).astype(np.int32),
            "cs_item_sk": (1 + rng.randint(0, n_items, n)).astype(np.int32),
            "cs_channel_sk": (1 + rng.randint(0, n_channel, n)
                              ).astype(np.int32),
            "cs_quantity": rng.randint(1, 100, n).astype(np.int32),
            "cs_ext_sales_price": np.round(rng.uniform(1.0, 300.0, n), 2),
            "cs_net_profit": np.round(rng.uniform(-100.0, 200.0, n), 2),
        }
    return _iter_fact(spec, n_rows, seed, 131, batch_rows)


def gen_channel_sales(n_rows: int, device, n_items: int = 2000,
                      seed: int = 17, n_channel: int = 50,
                      batch_rows: int = 1 << 19) -> List[ColumnarBatch]:
    return [fact_batch(d, v, CHANNEL_SALES_SCHEMA, device)
            for d, v in iter_channel_sales(n_rows, n_items, seed, n_channel,
                                           batch_rows)]


def iter_channel_returns(n_rows: int, n_items: int = 2000, seed: int = 19,
                         n_channel: int = 50, batch_rows: int = 1 << 19
                         ) -> Iterator[Tuple[Columns, Columns]]:
    """Returns chunks of one channel (stride 137)."""
    def spec(rng, n):
        return {
            "cr_returned_date_sk": (2450000 + rng.randint(0, 6 * 365, n)
                                    ).astype(np.int32),
            "cr_item_sk": (1 + rng.randint(0, n_items, n)).astype(np.int32),
            "cr_channel_sk": (1 + rng.randint(0, n_channel, n)
                              ).astype(np.int32),
            "cr_return_amount": np.round(rng.uniform(1.0, 150.0, n), 2),
            "cr_net_loss": np.round(rng.uniform(0.5, 80.0, n), 2),
        }
    return _iter_fact(spec, n_rows, seed, 137, batch_rows)


def gen_channel_returns(n_rows: int, device, n_items: int = 2000,
                        seed: int = 19, n_channel: int = 50,
                        batch_rows: int = 1 << 19) -> List[ColumnarBatch]:
    return [fact_batch(d, v, CHANNEL_RETURNS_SCHEMA, device)
            for d, v in iter_channel_returns(n_rows, n_items, seed,
                                             n_channel, batch_rows)]


def _aliased(df, prefix: str):
    """date_dim appears up to three times per query; rename its columns so
    the repeated joins do not collide."""
    from spark_rapids_tpu_torch.expressions import col
    return df.select(*[col(n).alias(f"{prefix}_{n[2:]}")
                       for n in df.schema.names])


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


def q5_subset(store_sales_df, date_dim_df):
    """The store-channel leg of TPC-DS Q5: per-store rollup of sales and
    profit over a date window."""
    from spark_rapids_tpu_torch.expressions import col, lit, sum_
    return (store_sales_df
            .join(date_dim_df, on=([col("ss_sold_date_sk")],
                                   [col("d_date_sk")]))
            .filter((col("d_year") == lit(2000)) & (col("d_moy") <= lit(2)))
            .group_by("ss_store_sk")
            .agg(sum_("ss_ext_sales_price").alias("sales"),
                 sum_("ss_net_profit").alias("profit")))


def q14a_subset(store_sales_df, item_df):
    """Q14a's cross-channel core: per (brand, category) sales with an item
    filter."""
    from spark_rapids_tpu_torch.expressions import avg, col, count, lit, sum_
    hot_items = (item_df.filter(col("i_category_id") <= lit(3))
                 .select("i_item_sk", "i_brand_id", "i_category",
                         "i_category_id"))
    return (store_sales_df
            .join(hot_items, on=([col("ss_item_sk")], [col("i_item_sk")]))
            .group_by("i_brand_id", "i_category")
            .agg(sum_(col("ss_ext_sales_price")).alias("sales"),
                 count().alias("n"),
                 avg("ss_quantity").alias("avg_qty")))


def q5(channels, date_dim_df):
    """TPC-DS Q5 (full shape): per-channel sales, returns and profit,
    rolled up.

    channels: {name: (sales_df, returns_df)} for the store, catalog and
    web legs.  Each leg unions its sales rows (+price, +profit) with its
    returns rows (the return amount, -net loss as profit) and names its
    channel; the legs are unioned, joined to a one-month date window,
    then ``group by rollup(channel, id)`` and sorted (union -> join ->
    expand -> aggregate -> sort, the reference query's plan shape).
    """
    from spark_rapids_tpu_torch.expressions import col, lit, sum_
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    legs = []
    for name, (sales_df, returns_df) in channels.items():
        s = sales_df.select(
            col("cs_sold_date_sk").alias("date_sk"),
            col("cs_channel_sk").alias("id"),
            col("cs_ext_sales_price").alias("sales_price"),
            lit(0.0).alias("return_amt"),
            col("cs_net_profit").alias("profit"),
            lit(0.0).alias("net_loss"))
        r = returns_df.select(
            col("cr_returned_date_sk").alias("date_sk"),
            col("cr_channel_sk").alias("id"),
            lit(0.0).alias("sales_price"),
            col("cr_return_amount").alias("return_amt"),
            lit(0.0).alias("profit"),
            col("cr_net_loss").alias("net_loss"))
        legs.append(s.union(r).with_column("channel", lit(name)))
    all_rows = legs[0]
    for leg in legs[1:]:
        all_rows = all_rows.union(leg)
    dated = all_rows.join(
        date_dim_df.filter((col("d_year") == lit(2000))
                           & (col("d_moy") == lit(1))),
        on=([col("date_sk")], [col("d_date_sk")]))
    return (dated.rollup("channel", "id")
            .agg(sum_("sales_price").alias("sales"),
                 sum_("return_amt").alias("returns_"),
                 (sum_("profit") - sum_("net_loss")).alias("profit"))
            .order_by(("channel", SortOrder(True, True)),
                      ("id", SortOrder(True, True))))


def q14a(store_sales_df, catalog_sales_df, web_sales_df, item_df,
         avg_threshold=None):
    """TPC-DS Q14a (full shape): cross-channel items and the average-sales
    gate.

    cross_items: the (brand, manufacturer, category) triples sold in all
    three channels, as two left semi joins (the intersect).
    ``avg_threshold`` plays the avg_sales scalar subquery: where None it
    is computed from the union of the three channels' prices and read back
    to the host, as Spark's subquery broadcast is.  Then each channel's
    sales above the average whose triple is a cross item (a left semi
    join), unioned, rolled up by channel, brand and category, and sorted.
    """
    from spark_rapids_tpu_torch.expressions import col, count, lit, sum_
    from spark_rapids_tpu_torch.kernels.sort import SortOrder

    def branded(sales_df):
        return sales_df.join(
            item_df.select("i_item_sk", "i_brand_id", "i_manufact_id",
                           "i_category_id"),
            on=([col("cs_item_sk")], [col("i_item_sk")]))

    ss_b = branded(store_sales_df)
    cs_b = branded(catalog_sales_df)
    ws_b = branded(web_sales_df)

    keys = ["i_brand_id", "i_manufact_id", "i_category_id"]

    def kcols():
        return [col(k) for k in keys], [col(k) for k in keys]
    cross_items = (ss_b.select(*keys)
                   .join(cs_b.select(*keys), on=kcols(), how="left_semi")
                   .join(ws_b.select(*keys), on=kcols(), how="left_semi"))

    if avg_threshold is None:
        avg_threshold = q14a_threshold(store_sales_df, catalog_sales_df,
                                       web_sales_df)

    legs = []
    for name, df in (("store", ss_b), ("catalog", cs_b), ("web", ws_b)):
        leg = (df.filter(col("cs_ext_sales_price") > lit(avg_threshold))
               .join(cross_items, on=kcols(), how="left_semi")
               .with_column("channel", lit(name)))
        legs.append(leg.select("channel", "i_brand_id", "i_category_id",
                               "cs_ext_sales_price"))
    all_rows = legs[0]
    for leg in legs[1:]:
        all_rows = all_rows.union(leg)
    return (all_rows.rollup("channel", "i_brand_id", "i_category_id")
            .agg(sum_("cs_ext_sales_price").alias("sales"),
                 count().alias("n"))
            .order_by(("channel", SortOrder(True, True)),
                      ("i_brand_id", SortOrder(True, True)),
                      ("i_category_id", SortOrder(True, True)),
                      ("sales", SortOrder(False))))


def q14a_threshold(store_sales_df, catalog_sales_df, web_sales_df):
    """q14a's scalar subquery: the average extended sales price over the
    union of the three channels, run as its own query and read back to the
    host."""
    from spark_rapids_tpu_torch.expressions import avg
    union_prices = (store_sales_df.select("cs_ext_sales_price")
                    .union(catalog_sales_df.select("cs_ext_sales_price"))
                    .union(web_sales_df.select("cs_ext_sales_price")))
    rows = union_prices.agg(avg("cs_ext_sales_price").alias("a")).collect()
    return rows[0][0]


def q25(ss_df, sr_df, cs_df, dd_df, store_df, item_df):
    """TPC-DS Q25: the three-fact chain: a store sale, its return, and a
    later catalog purchase of the same item by the same customer, each in
    its own date window.

    select i_item_id, i_item_desc, s_store_id, s_store_name,
           sum(ss_net_profit), sum(sr_net_loss), sum(cs_net_profit)
    from store_sales, store_returns, catalog_sales, date_dim d1, d2, d3,
         store, item
    where d1.d_moy = 4 and d1.d_year = 2000 and d2.d_moy between 4 and 10
      and d2.d_year = 2000 and d3.d_moy between 4 and 10
      and d3.d_year = 2000 and the chain's keys match
    group by the four keys order by the four keys limit 100
    """
    from spark_rapids_tpu_torch.expressions import col, lit, sum_
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    d1 = _aliased(dd_df.filter((col("d_moy") == lit(4))
                               & (col("d_year") == lit(2000))), "d1")
    d2 = _aliased(dd_df.filter((col("d_moy") >= lit(4))
                               & (col("d_moy") <= lit(10))
                               & (col("d_year") == lit(2000))), "d2")
    d3 = _aliased(dd_df.filter((col("d_moy") >= lit(4))
                               & (col("d_moy") <= lit(10))
                               & (col("d_year") == lit(2000))), "d3")
    j = (ss_df
         .join(sr_df, on=([col("ss_ticket_number"), col("ss_item_sk")],
                          [col("sr_ticket_number"), col("sr_item_sk")]))
         .join(cs_df, on=([col("sr_customer_sk"), col("sr_item_sk")],
                          [col("cs_bill_customer_sk"), col("cs_item_sk")]))
         .join(d1, on=([col("ss_sold_date_sk")], [col("d1_date_sk")]))
         .join(d2, on=([col("sr_returned_date_sk")], [col("d2_date_sk")]))
         .join(d3, on=([col("cs_sold_date_sk")], [col("d3_date_sk")]))
         .join(store_df, on=([col("ss_store_sk")], [col("s_store_sk")]))
         .join(item_df, on=([col("ss_item_sk")], [col("i_item_sk")])))
    return (j.group_by("i_item_id", "i_item_desc", "s_store_id",
                       "s_store_name")
            .agg(sum_("ss_net_profit").alias("store_sales_profit"),
                 sum_("sr_net_loss").alias("store_returns_loss"),
                 sum_("cs_net_profit").alias("catalog_sales_profit"))
            .order_by(("i_item_id", SortOrder(True)),
                      ("i_item_desc", SortOrder(True)),
                      ("s_store_id", SortOrder(True)),
                      ("s_store_name", SortOrder(True)))
            .limit(100))


def q17(ss_df, sr_df, cs_df, dd_df, store_df, item_df, limit=100):
    """TPC-DS Q17, q25's three-fact chain with counts, averages and sample
    standard deviations of the three quantities.

    select i_item_id, i_item_desc, s_state,
           count(ss_quantity), avg(ss_quantity), stddev_samp(ss_quantity),
           stddev_samp(ss_quantity) / avg(ss_quantity), and the same of
           sr_return_quantity and cs_quantity
    from store_sales, store_returns, catalog_sales, date_dim d1, d2, d3,
         store, item
    where d1.d_quarter_name = '2001Q1' and d2.d_quarter_name in ('2001Q1',
      '2001Q2', '2001Q3') and d3.d_quarter_name in (the same) and the
      chain's keys match
    group by i_item_id, i_item_desc, s_state
    order by i_item_id, i_item_desc, s_state limit 100

    Cut to the generators' columns: they have no ``d_quarter_name``, so
    the quarters are ``d_year = 2001`` with ``d_moy`` 1-3 and 1-9; they
    have no ``s_state``, so ``s_store_name``, a low-cardinality store
    attribute, stands in for it.  ``limit=None`` leaves the LIMIT out, so
    that every group can be held.
    """
    from spark_rapids_tpu_torch.expressions import (avg, col, count, lit,
                                                    stddev)
    from spark_rapids_tpu_torch.kernels.sort import SortOrder

    def quarters(last_moy: int):
        return dd_df.filter((col("d_year") == lit(2001))
                            & (col("d_moy") >= lit(1))
                            & (col("d_moy") <= lit(last_moy)))
    d1 = _aliased(quarters(3), "d1")
    d2 = _aliased(quarters(9), "d2")
    d3 = _aliased(quarters(9), "d3")
    j = (ss_df
         .join(sr_df, on=([col("ss_ticket_number"), col("ss_item_sk")],
                          [col("sr_ticket_number"), col("sr_item_sk")]))
         .join(cs_df, on=([col("sr_customer_sk"), col("sr_item_sk")],
                          [col("cs_bill_customer_sk"), col("cs_item_sk")]))
         .join(d1, on=([col("ss_sold_date_sk")], [col("d1_date_sk")]))
         .join(d2, on=([col("sr_returned_date_sk")], [col("d2_date_sk")]))
         .join(d3, on=([col("cs_sold_date_sk")], [col("d3_date_sk")]))
         .join(store_df, on=([col("ss_store_sk")], [col("s_store_sk")]))
         .join(item_df, on=([col("ss_item_sk")], [col("i_item_sk")])))
    aggs = []
    for prefix, c in (("store_sales", "ss_quantity"),
                      ("store_returns", "sr_return_quantity"),
                      ("catalog_sales", "cs_quantity")):
        aggs += [count(c).alias(f"{prefix}_quantitycount"),
                 avg(c).alias(f"{prefix}_quantityave"),
                 stddev(c).alias(f"{prefix}_quantitystdev"),
                 (stddev(c) / avg(c)).alias(f"{prefix}_quantitycov")]
    out = (j.group_by("i_item_id", "i_item_desc", "s_store_name").agg(*aggs)
           .order_by(("i_item_id", SortOrder(True)),
                     ("i_item_desc", SortOrder(True)),
                     ("s_store_name", SortOrder(True))))
    return out if limit is None else out.limit(limit)


#: q98's dates: d_date_ord 417 is 1999-02-22 in gen_date_dim's calendar
#: (365-day years from 1998-01-01), and the range runs 30 days on
Q98_FIRST_DAY = 365 + 31 + 21
Q98_LAST_DAY = Q98_FIRST_DAY + 30
Q98_CATEGORIES = ("Sports", "Books", "Home")


def q98(ss_df, dd_df, item_df):
    """TPC-DS Q98, each item's share of its class's revenue.

    select i_item_id, i_item_desc, i_category, i_class, i_current_price,
           sum(ss_ext_sales_price) as itemrevenue,
           sum(ss_ext_sales_price) * 100 / sum(sum(ss_ext_sales_price))
             over (partition by i_class) as revenueratio
    from store_sales, item, date_dim
    where ss_item_sk = i_item_sk and i_category in ('Sports', 'Books',
      'Home') and ss_sold_date_sk = d_date_sk
      and d_date between cast('1999-02-22' as date)
                     and (cast('1999-02-22' as date) + 30 days)
    group by i_item_id, i_item_desc, i_category, i_class, i_current_price
    order by i_category, i_class, i_item_id, i_item_desc, revenueratio

    Cut to the generators' columns, as q17 is: ``i_brand`` (a string)
    stands in for ``i_class``, ``i_current_price`` is left out, and the
    dates are ``d_date_ord`` 417-447.  No LIMIT, as in the specification.
    The window sits inside arithmetic: a Window node under a Project.
    """
    from spark_rapids_tpu_torch.expressions import col, lit, over, sum_
    dd = dd_df.filter((col("d_date_ord") >= lit(Q98_FIRST_DAY))
                      & (col("d_date_ord") <= lit(Q98_LAST_DAY)))
    cat = col("i_category")
    item = item_df.filter((cat == lit(Q98_CATEGORIES[0]))
                          | (cat == lit(Q98_CATEGORIES[1]))
                          | (cat == lit(Q98_CATEGORIES[2])))
    keys = ("i_item_id", "i_item_desc", "i_category", "i_brand")
    return (ss_df
            .join(item, on=([col("ss_item_sk")], [col("i_item_sk")]))
            .join(dd, on=([col("ss_sold_date_sk")], [col("d_date_sk")]))
            .group_by(*keys)
            .agg(sum_("ss_ext_sales_price").alias("itemrevenue"))
            .select(*keys, col("itemrevenue"),
                    (col("itemrevenue") * lit(100) / over(
                        sum_("itemrevenue"), partition_by=["i_brand"])
                     ).alias("revenueratio"))
            .order_by("i_category", "i_brand", "i_item_id", "i_item_desc",
                      "revenueratio"))


def q72(cs_df, inv_df, warehouse_df, item_df, cd_df, hd_df, dd_df,
        promo_df, cr_df):
    """TPC-DS Q72, the join-heavy stress query: catalog sales against the
    inventory snapshots of their item with less stock on hand than the
    quantity sold, in the week of the sale, filtered by demographics, with
    left joins to promotion and catalog_returns and the promo / no-promo
    counts.

    select i_item_desc, w_warehouse_name, d1.d_week_seq,
           sum(case when p_promo_sk is null then 1 else 0 end) no_promo,
           sum(case when p_promo_sk is not null then 1 else 0 end) promo,
           count(*) total_cnt
    from catalog_sales
    join inventory on cs_item_sk = inv_item_sk
                  and inv_quantity_on_hand < cs_quantity
    join warehouse, item, customer_demographics, household_demographics,
         date_dim d1, d2, d3 on their keys
    left join promotion on cs_promo_sk = p_promo_sk
    left join catalog_returns on cr_item_sk = cs_item_sk
                             and cr_order_number = cs_order_number
    where d1.d_week_seq = d2.d_week_seq and d3.d_date > d1.d_date + 5
      and hd_buy_potential = '>10000' and d1.d_year = 1999
      and cd_marital_status = 'D'
    group by i_item_desc, w_warehouse_name, d1.d_week_seq
    order by total_cnt desc, i_item_desc, w_warehouse_name, d_week_seq
    limit 100
    """
    from spark_rapids_tpu_torch.expressions import (If, IsNull, col, count,
                                                    lit, sum_)
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    d1 = _aliased(dd_df.filter(col("d_year") == lit(1999)), "d1")
    d2 = _aliased(dd_df, "d2")
    d3 = _aliased(dd_df, "d3")
    cd = cd_df.filter(col("cd_marital_status") == lit("D"))
    hd = hd_df.filter(col("hd_buy_potential") == lit(">10000"))
    j = (cs_df
         .join(inv_df, on=([col("cs_item_sk")], [col("inv_item_sk")]),
               condition=(col("inv_quantity_on_hand") < col("cs_quantity")))
         .join(warehouse_df, on=([col("inv_warehouse_sk")],
                                 [col("w_warehouse_sk")]))
         .join(item_df, on=([col("cs_item_sk")], [col("i_item_sk")]))
         .join(cd, on=([col("cs_bill_cdemo_sk")], [col("cd_demo_sk")]))
         .join(hd, on=([col("cs_bill_hdemo_sk")], [col("hd_demo_sk")]))
         .join(d1, on=([col("cs_sold_date_sk")], [col("d1_date_sk")]))
         .join(d2, on=([col("inv_date_sk")], [col("d2_date_sk")]))
         .filter(col("d1_week_seq") == col("d2_week_seq"))
         .join(d3, on=([col("cs_ship_date_sk")], [col("d3_date_sk")]))
         .filter(col("d3_date_ord") > (col("d1_date_ord") + lit(5)))
         .join(promo_df, on=([col("cs_promo_sk")], [col("p_promo_sk")]),
               how="left")
         .join(cr_df, on=([col("cs_item_sk"), col("cs_order_number")],
                          [col("cr_item_sk"), col("cr_order_number")]),
               how="left"))
    return (j.group_by("i_item_desc", "w_warehouse_name", "d1_week_seq")
            .agg(sum_(If(IsNull(col("p_promo_sk")), lit(1), lit(0))
                      ).alias("no_promo"),
                 sum_(If(IsNull(col("p_promo_sk")), lit(0), lit(1))
                      ).alias("promo"),
                 count().alias("total_cnt"))
            .order_by(("total_cnt", SortOrder(False)),
                      ("i_item_desc", SortOrder(True)),
                      ("w_warehouse_name", SortOrder(True)),
                      ("d1_week_seq", SortOrder(True)))
            .limit(100))


def q7(store_sales_df, cd_df, dd_df, item_df, promo_df):
    """TPC-DS Q7: store sales to one demographic in 2000 under a promotion
    not run by email or not run as an event, averaged per item.

    select i_item_id, avg(ss_quantity) agg1, avg(ss_ext_sales_price) agg2,
           avg(ss_net_profit) agg3
    from store_sales, customer_demographics, date_dim, item, promotion
    where the keys match and cd_gender = 'M' and cd_marital_status = 'S'
      and cd_education_status = 'College'
      and (p_channel_email = 'N' or p_channel_event = 'N')
      and d_year = 2000
    group by i_item_id order by i_item_id limit 100
    """
    from spark_rapids_tpu_torch.expressions import avg, col, lit
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    cd = cd_df.filter((col("cd_gender") == lit("M"))
                      & (col("cd_marital_status") == lit("S"))
                      & (col("cd_education_status") == lit("College")))
    promo = promo_df.filter((col("p_channel_email") == lit("N"))
                            | (col("p_channel_event") == lit("N")))
    dd = dd_df.filter(col("d_year") == lit(2000))
    return (store_sales_df
            .join(cd, on=([col("ss_cdemo_sk")], [col("cd_demo_sk")]))
            .join(dd, on=([col("ss_sold_date_sk")], [col("d_date_sk")]))
            .join(item_df, on=([col("ss_item_sk")], [col("i_item_sk")]))
            .join(promo, on=([col("ss_promo_sk")], [col("p_promo_sk")]))
            .group_by("i_item_id")
            .agg(avg("ss_quantity").alias("agg1"),
                 avg("ss_ext_sales_price").alias("agg2"),
                 avg("ss_net_profit").alias("agg3"))
            .order_by(("i_item_id", SortOrder(True)))
            .limit(100))


def q19(store_sales_df, dd_df, item_df, customer_df, ca_df, store_df):
    """TPC-DS Q19: brand revenue of store sales to customers whose zip
    differs from the store's, for one manager and one month.

    select i_brand_id, i_brand, i_manufact_id, sum(ss_ext_sales_price)
    from date_dim, store_sales, item, customer, customer_address, store
    where the keys match and i_manager_id = 8 and d_moy = 11
      and d_year = 1999
      and substr(ca_zip, 1, 5) <> substr(s_zip, 1, 5)
    group by i_brand, i_brand_id, i_manufact_id
    order by ext_price desc, i_brand_id, i_manufact_id limit 100
    """
    from spark_rapids_tpu_torch.expressions import Substring, col, lit, sum_
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    dd = dd_df.filter((col("d_moy") == lit(11)) & (col("d_year") == lit(1999)))
    it = item_df.filter(col("i_manager_id") == lit(8))
    j = (store_sales_df
         .join(dd, on=([col("ss_sold_date_sk")], [col("d_date_sk")]))
         .join(it, on=([col("ss_item_sk")], [col("i_item_sk")]))
         .join(customer_df, on=([col("ss_customer_sk")],
                                [col("c_customer_sk")]))
         .join(ca_df, on=([col("c_current_addr_sk")],
                          [col("ca_address_sk")]))
         .join(store_df, on=([col("ss_store_sk")], [col("s_store_sk")]))
         .filter(Substring(col("ca_zip"), 1, 5)
                 != Substring(col("s_zip"), 1, 5)))
    return (j.group_by("i_brand_id", "i_brand", "i_manufact_id")
            .agg(sum_("ss_ext_sales_price").alias("ext_price"))
            .order_by(("ext_price", SortOrder(False)),
                      ("i_brand_id", SortOrder(True)),
                      ("i_manufact_id", SortOrder(True)))
            .limit(100))


def q26(cs_df, cd_df, dd_df, item_df, promo_df):
    """TPC-DS Q26: q7 over catalog sales, for another demographic."""
    from spark_rapids_tpu_torch.expressions import avg, col, lit
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    cd = cd_df.filter((col("cd_gender") == lit("F"))
                      & (col("cd_marital_status") == lit("W"))
                      & (col("cd_education_status") == lit("Primary")))
    promo = promo_df.filter((col("p_channel_email") == lit("N"))
                            | (col("p_channel_event") == lit("N")))
    dd = dd_df.filter(col("d_year") == lit(2000))
    return (cs_df
            .join(cd, on=([col("cs_bill_cdemo_sk")], [col("cd_demo_sk")]))
            .join(dd, on=([col("cs_sold_date_sk")], [col("d_date_sk")]))
            .join(item_df, on=([col("cs_item_sk")], [col("i_item_sk")]))
            .join(promo, on=([col("cs_promo_sk")], [col("p_promo_sk")]))
            .group_by("i_item_id")
            .agg(avg("cs_quantity").alias("agg1"),
                 avg("cs_ext_sales_price").alias("agg2"),
                 avg("cs_net_profit").alias("agg3"))
            .order_by(("i_item_id", SortOrder(True)))
            .limit(100))


def _month_sales(store_sales_df, dd_df, item_df, moy: int, year: int,
                 manager: int):
    """The store sales of one month, of one manager's items (q42, q52,
    q55)."""
    from spark_rapids_tpu_torch.expressions import col, lit
    dd = dd_df.filter((col("d_moy") == lit(moy))
                      & (col("d_year") == lit(year)))
    it = item_df.filter(col("i_manager_id") == lit(manager))
    return (store_sales_df
            .join(dd, on=([col("ss_sold_date_sk")], [col("d_date_sk")]))
            .join(it, on=([col("ss_item_sk")], [col("i_item_sk")])))


def q42(store_sales_df, dd_df, item_df):
    """TPC-DS Q42: category revenue for one month (manager 1, November
    2000), by year and category."""
    from spark_rapids_tpu_torch.expressions import sum_
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    return (_month_sales(store_sales_df, dd_df, item_df, 11, 2000, 1)
            .group_by("d_year", "i_category_id", "i_category")
            .agg(sum_("ss_ext_sales_price").alias("total"))
            .order_by(("total", SortOrder(False)),
                      ("d_year", SortOrder(True)),
                      ("i_category_id", SortOrder(True)),
                      ("i_category", SortOrder(True)))
            .limit(100))


def q52(store_sales_df, dd_df, item_df):
    """TPC-DS Q52: brand revenue for one month (manager 1, December
    1998), q42 at brand grain."""
    from spark_rapids_tpu_torch.expressions import sum_
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    return (_month_sales(store_sales_df, dd_df, item_df, 12, 1998, 1)
            .group_by("d_year", "i_brand_id", "i_brand")
            .agg(sum_("ss_ext_sales_price").alias("ext_price"))
            .order_by(("d_year", SortOrder(True)),
                      ("ext_price", SortOrder(False)),
                      ("i_brand_id", SortOrder(True)))
            .limit(100))


def q55(store_sales_df, dd_df, item_df):
    """TPC-DS Q55: brand revenue of one manager (28) in November 1999."""
    from spark_rapids_tpu_torch.expressions import sum_
    from spark_rapids_tpu_torch.kernels.sort import SortOrder
    return (_month_sales(store_sales_df, dd_df, item_df, 11, 1999, 28)
            .group_by("i_brand_id", "i_brand")
            .agg(sum_("ss_ext_sales_price").alias("ext_price"))
            .order_by(("ext_price", SortOrder(False)),
                      ("i_brand_id", SortOrder(True)))
            .limit(100))


def q96(store_sales_df, hd_df, td_df, store_df):
    """TPC-DS Q96: the store sales between 20:30 and 21:00 to households
    of four dependents at the stores named 'ese', counted.

    select count(*) from store_sales, household_demographics, time_dim,
         store
    where the keys match and t_hour = 20 and t_minute >= 30
      and hd_dep_count = 4 and s_store_name = 'ese'
    """
    from spark_rapids_tpu_torch.expressions import col, count, lit
    hd = hd_df.filter(col("hd_dep_count") == lit(4))
    td = td_df.filter((col("t_hour") == lit(20))
                      & (col("t_minute") >= lit(30)))
    st = store_df.filter(col("s_store_name") == lit("ese"))
    return (store_sales_df
            .join(hd, on=([col("ss_hdemo_sk")], [col("hd_demo_sk")]))
            .join(td, on=([col("ss_sold_time_sk")], [col("t_time_sk")]))
            .join(st, on=([col("ss_store_sk")], [col("s_store_sk")]))
            .agg(count().alias("cnt")))
