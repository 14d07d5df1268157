"""The port's columnar layer against the JAX package, on the CPU.

Data crosses between the packages as numpy arrays and Arrow tables: the
port's lineitem generator must draw the reference's numbers, and a
reference batch must survive to_arrow -> arrow_to_batch -> to_arrow.
"""
import decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.columnar.batch import ColumnarBatch as JaxBatch
from spark_rapids_tpu.testing import tpch as jax_tpch

from spark_rapids_tpu_torch import types as PT
from spark_rapids_tpu_torch.columnar.arrow import (arrow_to_batch,
                                                   batch_from_numpy)
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.testing import tpch as port_tpch


@pytest.mark.parametrize("seed,num_rows,batch_rows",
                         [(42, 10_000, 4_001), (7, 9_999, 2_500)])
def test_gen_lineitem_matches_reference(seed, num_rows, batch_rows):
    ref = jax_tpch.gen_lineitem(num_rows, seed=seed, batch_rows=batch_rows)
    port = port_tpch.gen_lineitem(num_rows, seed=seed, batch_rows=batch_rows)
    assert len(ref) == len(port)
    assert port_tpch.LINEITEM_SCHEMA.names == jax_tpch.LINEITEM_SCHEMA.names
    for rb, pc in zip(ref, port):
        n = rb.host_num_rows()
        for name, col in zip(rb.schema.names, rb.columns):
            vals, valid = col.to_numpy(n)
            assert valid.all()
            assert pc[name].dtype == vals.dtype, name
            np.testing.assert_array_equal(pc[name], vals, err_msg=name)


def _null_laced_table(n: int, seed: int) -> pa.Table:
    rng = np.random.RandomState(seed)

    def mask():
        return rng.rand(n) < 0.1
    ints = rng.randint(-1000, 1000, n)
    return pa.table({
        "i": pa.array(ints.astype(np.int32), mask=mask()),
        "l": pa.array(rng.randint(-2**62, 2**62, n, dtype=np.int64),
                      mask=mask()),
        "d": pa.array(rng.uniform(-1e6, 1e6, n), mask=mask()),
        "b": pa.array(rng.rand(n) < 0.5, mask=mask()),
        "dt": pa.array(rng.randint(0, 20_000, n).astype(np.int32),
                       mask=mask()).cast(pa.date32()),
        "dec": pa.array([None if m else decimal.Decimal(int(v)).scaleb(-2)
                         for v, m in zip(rng.randint(-10**11, 10**11, n),
                                         mask())],
                        type=pa.decimal128(12, 2)),
    })


@pytest.mark.parametrize("source", ["lineitem", "null_laced", "empty"])
def test_reference_batch_survives_arrow_round_trip(source):
    if source == "lineitem":
        ref = jax_tpch.gen_lineitem(3_000, batch_rows=3_000)[0]
    elif source == "null_laced":
        ref = JaxBatch.from_arrow(_null_laced_table(2_000, 3))
    else:
        ref = JaxBatch.from_arrow(_null_laced_table(0, 3))
    table = ref.to_arrow()
    port = arrow_to_batch(table, "cpu")
    assert port.num_rows == table.num_rows
    assert port.device == torch.device("cpu")
    assert port.to_arrow().equals(table)


def test_batch_from_numpy_matches_arrow_path():
    table = _null_laced_table(500, 11)
    via_arrow = arrow_to_batch(table, "cpu")
    arrays = {}
    for name, c in zip(via_arrow.schema.names, via_arrow.columns):
        arrays[name] = c.to_numpy()
    via_numpy = batch_from_numpy(arrays, via_arrow.schema, "cpu")
    assert via_numpy.to_arrow().equals(table)
    assert via_numpy.rows() == [tuple(r.values()) for r in table.to_pylist()]


def test_null_slots_hold_zero_and_types_map_to_torch():
    port = arrow_to_batch(_null_laced_table(300, 5), "cpu")
    for c in port.columns:
        assert c.data.dtype == c.dtype.torch_dtype
        assert not c.data[~c.validity].any()
    assert port.schema.dtype_of("dec") == PT.DecimalType(12, 2)
    assert port.column("dt").data.dtype == torch.int32
    picked = port.select(["dec", "i"])
    assert picked.schema.names == ("dec", "i")
    assert picked.columns[1] is port.column("i")


def test_unported_types_and_conf_raise():
    with pytest.raises(NotImplementedError, match="decimal"):
        PT.DecimalType(20, 2)
    with pytest.raises(NotImplementedError, match="string"):
        arrow_to_batch(pa.table({"s": ["a"]}), "cpu")
    assert RapidsConf().batch_size_rows == 1 << 20
    assert not RapidsConf({"spark.rapids.sql.enabled": "false"}).sql_enabled
