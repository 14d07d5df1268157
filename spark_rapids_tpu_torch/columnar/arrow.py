"""pyarrow / numpy <-> device-batch interop, fixed-width and string types.

Counterpart of ``spark_rapids_tpu/columnar/arrow.py`` (``arrow_to_batch``
:185, ``batch_to_arrow`` :201).  This is the seam that carries state from
the reference package to the port: a reference batch's ``to_arrow()`` table
goes through ``arrow_to_batch`` unchanged.  Decimal64 values cross as their
int64 unscaled value, read from and written to the low half of Arrow's
16-byte decimal128 slots without Python objects.  Strings cross as Arrow's
offsets and bytes: ``utf8`` and ``large_utf8`` come in, ``utf8`` goes out,
and a null slot that Arrow gave bytes loses them (the port's null row has
length 0).
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import numpy as np
import pyarrow as pa

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

_ARROW_TO_SQL = {
    pa.bool_(): T.BOOLEAN,
    pa.int32(): T.INT,
    pa.int64(): T.LONG,
    pa.float32(): T.FLOAT,
    pa.float64(): T.DOUBLE,
    pa.date32(): T.DATE,
    pa.string(): T.STRING,
}


def arrow_type_to_sql(at: pa.DataType) -> T.DataType:
    if at in _ARROW_TO_SQL:
        return _ARROW_TO_SQL[at]
    if pa.types.is_decimal128(at):
        return T.DecimalType(at.precision, at.scale)
    if pa.types.is_large_string(at):
        return T.STRING
    raise NotImplementedError(f"arrow type {at} is not ported")


def sql_type_to_arrow(dt: T.DataType) -> pa.DataType:
    if isinstance(dt, T.DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    for at, sql in _ARROW_TO_SQL.items():
        if sql == dt:
            return at
    raise NotImplementedError(f"sql type {dt!r} is not ported")


def _validity_of(arr: pa.Array) -> np.ndarray:
    if arr.null_count:
        return arr.is_valid().to_numpy(zero_copy_only=False)
    return np.ones((len(arr),), np.bool_)


def arrow_column_to_numpy(arr, dtype: T.DataType
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """One Arrow column -> (values in dtype.np_dtype, validity)."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    valid = _validity_of(arr)
    if isinstance(dtype, T.DecimalType):
        # decimal128 slots are 16-byte little-endian two's complement; a
        # Decimal64 value is the low 8 bytes
        words = np.frombuffer(arr.buffers()[1], dtype=np.int64)
        vals = words[2 * arr.offset: 2 * (arr.offset + len(arr)): 2].copy()
    elif isinstance(dtype, T.BooleanType):
        vals = arr.fill_null(False).to_numpy(zero_copy_only=False)
    else:
        if isinstance(dtype, T.DateType):
            arr = arr.cast(pa.int32())
        vals = arr.fill_null(0).to_numpy(zero_copy_only=False)
    return np.asarray(vals, dtype=dtype.np_dtype), valid


def arrow_strings_to_numpy(arr) -> Tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
    """One Arrow utf8 / large_utf8 column -> (int32 offsets from 0, uint8
    bytes, validity), null rows of length 0."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    n = len(arr)
    valid = _validity_of(arr)
    odt = np.int64 if pa.types.is_large_string(arr.type) else np.int32
    bufs = arr.buffers()
    off = np.frombuffer(bufs[1], odt)[arr.offset: arr.offset + n + 1] \
        .astype(np.int64) if n else np.zeros(1, np.int64)
    raw = (np.frombuffer(bufs[2], np.uint8) if bufs[2] is not None
           else np.zeros(0, np.uint8))
    data = raw[off[0]: off[-1]]
    lengths = np.diff(off)
    if (lengths[~valid] != 0).any():
        data = data[np.repeat(valid, lengths)]
        lengths = np.where(valid, lengths, 0)
    out = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=out[1:])
    if out[-1] >= 2**31:
        raise ValueError("a string column holds < 2**31 bytes")
    return out.astype(np.int32), np.ascontiguousarray(data), valid


def arrow_to_batch(table, device) -> ColumnarBatch:
    """pyarrow Table/RecordBatch -> one device batch on ``device``."""
    if isinstance(table, pa.RecordBatch):
        table = pa.Table.from_batches([table])
    names, dtypes, cols = [], [], []
    for field, col in zip(table.schema, table.columns):
        dt = arrow_type_to_sql(field.type)
        names.append(field.name)
        dtypes.append(dt)
        if dt.variable_width:
            cols.append(DeviceColumn.from_string_buffers(
                *arrow_strings_to_numpy(col), device))
            continue
        vals, valid = arrow_column_to_numpy(col, dt)
        cols.append(DeviceColumn.from_numpy(vals, dt, valid, device))
    return ColumnarBatch(tuple(cols), table.num_rows,
                         Schema(tuple(names), tuple(dtypes)))


def batch_from_numpy(
        arrays: Dict[str, Union[np.ndarray, Tuple[np.ndarray, np.ndarray]]],
        schema: Schema, device) -> ColumnarBatch:
    """Host numpy columns -> one device batch.

    ``arrays[name]`` is a values array (no nulls) or a (values, validity)
    pair.  Decimal columns are given as int64 unscaled values; a STRING
    column as a list of str (None is null) or an (offsets, bytes,
    validity) triple."""
    cols = []
    for name, dt in zip(schema.names, schema.dtypes):
        a = arrays[name]
        if dt.variable_width:
            cols.append(DeviceColumn.from_string_buffers(*a, device)
                        if isinstance(a, tuple)
                        else DeviceColumn.from_strings(a, device))
            continue
        vals, valid = a if isinstance(a, tuple) else (a, None)
        cols.append(DeviceColumn.from_numpy(vals, dt, valid, device))
    n = cols[0].num_rows if cols else 0
    return ColumnarBatch(tuple(cols), n, schema)


def _column_to_arrow(col: DeviceColumn) -> pa.Array:
    if col.is_string:
        off, data, valid = col.string_buffers()
        mask_buf = (pa.array(valid).buffers()[1] if not valid.all() else None)
        return pa.Array.from_buffers(pa.string(), len(valid), [
            mask_buf, pa.py_buffer(off), pa.py_buffer(data)])
    vals, valid = col.to_numpy()
    n = len(vals)
    mask_buf = (pa.array(valid).buffers()[1] if not valid.all() else None)
    at = sql_type_to_arrow(col.dtype)
    if isinstance(col.dtype, T.DecimalType):
        words = np.empty((n, 2), np.int64)
        words[:, 0] = vals
        words[:, 1] = vals >> 63       # sign extension into the high half
        return pa.Array.from_buffers(at, n, [mask_buf, pa.py_buffer(words)])
    if isinstance(col.dtype, T.BooleanType):
        return pa.array(vals, type=at, mask=~valid)
    base = pa.array(vals, mask=~valid)
    return base if base.type == at else base.cast(at)


def batch_to_arrow(batch: ColumnarBatch) -> pa.Table:
    arrays = [_column_to_arrow(c) for c in batch.columns]
    fields = [pa.field(n, sql_type_to_arrow(d))
              for n, d in zip(batch.schema.names, batch.schema.dtypes)]
    return pa.Table.from_arrays(arrays, schema=pa.schema(fields))
