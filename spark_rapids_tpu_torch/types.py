"""Spark SQL data types of the port, each mapped to a torch dtype.

Counterpart of ``spark_rapids_tpu/types.py:72-188``, cut to the types the
TPC-H lineitem table, q6, q1 and TPC-DS q3 use: BOOLEAN, INT, LONG, FLOAT
(the held aggregate shapes' float32 column), DOUBLE, DATE, Decimal64
(precision <= 18, held as its int64 unscaled value) and STRING (UTF-8
bytes, variable width; ``StringType`` :138).  Every type
carries the torch dtype of its device buffer and the numpy dtype used for
host staging.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


class DataType:
    """Base of the SQL type lattice."""

    torch_dtype: torch.dtype = None
    np_dtype = None
    sql_name = "unknown"
    byte_width = 0
    variable_width = False

    def __repr__(self) -> str:
        return self.sql_name

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, IntegralType)

    @property
    def is_floating(self) -> bool:
        return isinstance(self, FractionalType) and not isinstance(self, DecimalType)


class NumericType(DataType):
    pass


class IntegralType(NumericType):
    pass


class FractionalType(NumericType):
    pass


class BooleanType(DataType):
    torch_dtype = torch.bool
    np_dtype = np.bool_
    sql_name = "boolean"
    byte_width = 1


class IntegerType(IntegralType):
    torch_dtype = torch.int32
    np_dtype = np.int32
    sql_name = "int"
    byte_width = 4


class LongType(IntegralType):
    torch_dtype = torch.int64
    np_dtype = np.int64
    sql_name = "bigint"
    byte_width = 8


class FloatType(FractionalType):
    torch_dtype = torch.float32
    np_dtype = np.float32
    sql_name = "float"
    byte_width = 4


class DoubleType(FractionalType):
    torch_dtype = torch.float64
    np_dtype = np.float64
    sql_name = "double"
    byte_width = 8


class DateType(DataType):
    """Days since epoch, int32 on the device (Spark's DateType)."""

    torch_dtype = torch.int32
    np_dtype = np.int32
    sql_name = "date"
    byte_width = 4


class StringType(DataType):
    """UTF-8 bytes in the Arrow layout: int32 offsets[n + 1] + uint8 data
    (see columnar/column.py)."""

    torch_dtype = torch.uint8
    np_dtype = np.uint8
    sql_name = "string"
    byte_width = 1
    variable_width = True


@dataclasses.dataclass(frozen=True, eq=False)
class DecimalType(FractionalType):
    """Decimal(precision, scale) held as an int64 unscaled value.

    Only Decimal64 (precision <= 18) exists in this port; the two-limb
    decimal128 layout of the reference comes with its kernels later.
    """

    precision: int = 10
    scale: int = 0
    sql_name = "decimal"
    byte_width = 8
    torch_dtype = torch.int64
    np_dtype = np.int64

    MAX_LONG_DIGITS = 18

    def __post_init__(self):
        if not (1 <= self.precision <= self.MAX_LONG_DIGITS):
            raise NotImplementedError(
                f"decimal({self.precision},{self.scale}): only precision "
                f"<= {self.MAX_LONG_DIGITS} (Decimal64) is ported")
        if not (0 <= self.scale <= self.precision):
            raise ValueError(f"decimal scale out of range: {self.scale}")

    def __eq__(self, other) -> bool:
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self) -> int:
        return hash((DecimalType, self.precision, self.scale))

    def __repr__(self) -> str:
        return f"decimal({self.precision},{self.scale})"


BOOLEAN = BooleanType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
DATE = DateType()
STRING = StringType()

_NUMERIC_WIDEN_ORDER = [INT, LONG, DOUBLE]


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic promotion for non-decimal numeric types."""
    if a == b:
        return a
    if a not in _NUMERIC_WIDEN_ORDER or b not in _NUMERIC_WIDEN_ORDER:
        raise NotImplementedError(f"numeric promotion of {a!r} and {b!r}")
    return _NUMERIC_WIDEN_ORDER[max(_NUMERIC_WIDEN_ORDER.index(a),
                                    _NUMERIC_WIDEN_ORDER.index(b))]
