"""Spark SQL data types of the port, each mapped to a torch dtype.

Counterpart of ``spark_rapids_tpu/types.py:72-188``, cut to the types the
TPC-H lineitem table, q6, q1 and TPC-DS q3 use: BOOLEAN, BYTE and SHORT
(``tinyint`` / ``smallint``, :78-92), INT, LONG, FLOAT (the held
aggregate shapes' float32 column), DOUBLE, DATE, TIMESTAMP
(``TimestampType`` :129: int64 microseconds since the epoch, UTC), the
null type of an untyped ``NULL`` literal (``NullType`` :156), DECIMAL
(``DecimalType`` :167:
Decimal64, precision <= 18, held as its int64 unscaled value, and
Decimal128, precision 19-38, held as two int64 limbs; a Decimal128 is a
value column only), STRING (UTF-8 bytes, variable width;
``StringType`` :138) and one array, array<tinyint> of a fixed length
(``ArrayType`` :217, HyperLogLog++'s registers).  Every type
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


class ByteType(IntegralType):
    torch_dtype = torch.int8
    np_dtype = np.int8
    sql_name = "tinyint"
    byte_width = 1


class ShortType(IntegralType):
    torch_dtype = torch.int16
    np_dtype = np.int16
    sql_name = "smallint"
    byte_width = 2


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


class TimestampType(DataType):
    """Microseconds since 1970-01-01 00:00:00 UTC, int64 on the device
    (Spark's TimestampType)."""

    torch_dtype = torch.int64
    np_dtype = np.int64
    sql_name = "timestamp"
    byte_width = 8


class NullType(DataType):
    """The type of an untyped ``NULL`` literal: an all-null int8 column."""

    torch_dtype = torch.int8
    np_dtype = np.int8
    sql_name = "void"
    byte_width = 1


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
    """Decimal(precision, scale), held as its unscaled integer.

    Precision <= 18 (Decimal64): int64 ``data[n]``.  Precision 19-38
    (Decimal128, ``uses_two_limbs``): int64 ``data[n, 2]`` holding each
    row's (low, high) limbs of the 128-bit two's complement value, which
    is Arrow's 16-byte little-endian ``decimal128`` slot; the kernels are
    in ``kernels/decimal.py``.
    """

    precision: int = 10
    scale: int = 0
    sql_name = "decimal"
    torch_dtype = torch.int64
    np_dtype = np.int64

    MAX_PRECISION = 38
    MAX_LONG_DIGITS = 18

    def __post_init__(self):
        if not (1 <= self.precision <= self.MAX_PRECISION):
            raise ValueError(f"decimal precision out of range: "
                             f"{self.precision}")
        if not (0 <= self.scale <= self.precision):
            raise ValueError(f"decimal scale out of range: {self.scale}")

    @property
    def uses_two_limbs(self) -> bool:
        return self.precision > self.MAX_LONG_DIGITS

    @property
    def byte_width(self) -> int:  # type: ignore[override]
        return 16 if self.uses_two_limbs else 8

    def __eq__(self, other) -> bool:
        return (isinstance(other, DecimalType)
                and other.precision == self.precision
                and other.scale == self.scale)

    def __hash__(self) -> int:
        return hash((DecimalType, self.precision, self.scale))

    def __repr__(self) -> str:
        return f"decimal({self.precision},{self.scale})"


@dataclasses.dataclass(frozen=True, eq=False)
class ArrayType(DataType):
    """array<tinyint> without null elements, the one array the port holds
    (``ArrayType`` :217 in the form HyperLogLog++'s buffer takes,
    ``expressions/aggregates.py:531`` of the reference).  Every row holds
    the same number of elements, so the column is fixed-stride: ``data``
    int8 ``[n, length]``, the way a Decimal128 is int64 ``[n, 2]``, with
    no offsets (the reference packs an offsets-based array,
    ``_hll_array_col`` :250, and reads it back as ``[n, m]``,
    ``_hll_regs2d`` :264).  ``length`` (required, at least 1) is every
    row's number of elements.  Any other array raises: nested types are
    not ported (ROADMAP queue 1, item 11 (rest))."""

    element_type: DataType = None  # type: ignore[assignment]
    contains_null: bool = True
    length: int = 0
    sql_name = "array"
    torch_dtype = torch.int8
    np_dtype = np.int8
    byte_width = 1

    def __post_init__(self):
        if not isinstance(self.element_type, ByteType) or self.contains_null:
            raise NotImplementedError(
                f"array<{self.element_type!r}> (contains_null="
                f"{self.contains_null}): nested types are not ported")
        if not isinstance(self.length, int) or self.length < 1:
            raise ValueError(f"a fixed-length array of {self.length} "
                             "elements")

    def __eq__(self, other) -> bool:
        return isinstance(other, ArrayType) and other.length == self.length

    def __hash__(self) -> int:
        return hash((ArrayType, self.length))

    def __repr__(self) -> str:
        return f"array<{self.element_type!r}>"


def two_limbs(dtype: DataType) -> bool:
    """A Decimal128: its column's data is int64 [n, 2]."""
    return isinstance(dtype, DecimalType) and dtype.uses_two_limbs


def row_shape(dtype: DataType) -> tuple:
    """The trailing shape of a fixed-width column's ``data``: (2,) for a
    Decimal128's limbs, (length,) for a fixed-length array, () otherwise."""
    if two_limbs(dtype):
        return (2,)
    if isinstance(dtype, ArrayType):
        return (dtype.length,)
    return ()


BOOLEAN = BooleanType()
BYTE = ByteType()
SHORT = ShortType()
INT = IntegerType()
LONG = LongType()
FLOAT = FloatType()
DOUBLE = DoubleType()
DATE = DateType()
TIMESTAMP = TimestampType()
NULL = NullType()
STRING = StringType()

#: the reference's widening order (``types.py:336``)
_NUMERIC_WIDEN_ORDER = [BYTE, SHORT, INT, LONG, FLOAT, DOUBLE]


def numeric_promote(a: DataType, b: DataType) -> DataType:
    """Spark's binary-arithmetic promotion for non-decimal numeric types
    (``numeric_promote`` :354): the later of the two in BYTE, SHORT, INT,
    LONG, FLOAT, DOUBLE."""
    if a == b:
        return a
    if a not in _NUMERIC_WIDEN_ORDER or b not in _NUMERIC_WIDEN_ORDER:
        raise NotImplementedError(f"numeric promotion of {a!r} and {b!r}")
    return _NUMERIC_WIDEN_ORDER[max(_NUMERIC_WIDEN_ORDER.index(a),
                                    _NUMERIC_WIDEN_ORDER.index(b))]


def key_type_not_ported(dtype: DataType, what: str) -> NotImplementedError:
    """The error for a type the port does not take as a ``what`` key."""
    return NotImplementedError(f"{what} of {dtype!r} is not ported")
