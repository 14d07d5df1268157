"""Device column of the port: exact-size tensors.

Counterpart of ``spark_rapids_tpu/columnar/column.py`` (``DeviceColumn``
:42), fixed-width and string layouts.  The reference pads every column to
a power-of-two capacity and carries a dynamic row count, because XLA needs
static shapes.  PyTorch runs eagerly, so a fixed-width column here is
exactly ``data[n]`` plus ``validity[n]`` (bool, True = non-null), and the
row count is the host int ``n``.  Null slots hold zero, as in the
reference.

A Decimal128 column (``T.two_limbs``) holds ``data`` as int64 ``[n, 2]``:
each row's low and high limbs, Arrow's 16-byte ``decimal128`` slot.  Its
host values are Python ints (the unscaled value): ``from_pylist`` and
``to_pylist`` carry them exactly (``const128`` / ``to_python``, the
reference's ``kernels/decimal.py:33`` and ``:45``).

A fixed-length array column (``T.ArrayType``, array<tinyint>:
HyperLogLog++'s registers) holds ``data`` as int8 ``[n, length]`` in the
same way: a fixed-stride row, no offsets.

A STRING column is ``offsets`` (int32 ``[n + 1]``), ``data`` (uint8 bytes)
and ``validity[n]``: row i is ``data[offsets[i]:offsets[i + 1]]`` and a
null row has length 0.  The offsets need not start at 0, so a slice of
rows is a view of the same bytes (``slice_rows``) with no host read; every
kernel reads a row through its two offsets, and ``to_pylist`` rebases.
"""
from __future__ import annotations

import dataclasses
import decimal as _decimal
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

_U128 = (1 << 128) - 1


def const128(value: int) -> Tuple[int, int]:
    """A Python int -> its (low, high) int64 limbs, two's complement
    modulo 2**128."""
    v = value & _U128
    lo, hi = v & (2**64 - 1), v >> 64
    return (lo - (1 << 64) if lo >= 1 << 63 else lo,
            hi - (1 << 64) if hi >= 1 << 63 else hi)


def _unscaled(v, scale: int) -> int:
    """A decimal's unscaled int: an int as it is, a ``decimal.Decimal`` at
    its value, exactly (38 digits pass the default context's 28)."""
    if not isinstance(v, _decimal.Decimal):
        return int(v)
    with _decimal.localcontext() as ctx:
        ctx.prec = 80
        return int(v.scaleb(scale))


def to_python(lo: int, hi: int) -> int:
    """(low, high) int64 limbs -> the signed Python int."""
    return (int(hi) << 64) | (int(lo) & (2**64 - 1))


@dataclasses.dataclass
class DeviceColumn:
    data: torch.Tensor       # [n] of dtype.torch_dtype ([n, 2] for a
                             # Decimal128); uint8 bytes for strings
    validity: torch.Tensor   # [n] bool
    dtype: T.DataType
    offsets: Optional[torch.Tensor] = None   # int32 [n + 1], strings only

    def __post_init__(self):
        if self.data.dtype != self.dtype.torch_dtype:
            raise TypeError(f"{self.dtype!r} column needs "
                            f"{self.dtype.torch_dtype}, got {self.data.dtype}")
        if self.validity.dtype != torch.bool or self.validity.dim() != 1:
            raise TypeError(f"validity must be 1-d bool, got "
                            f"{self.validity.dtype} {tuple(self.validity.shape)}")
        if T.two_limbs(self.dtype):
            if self.data.dim() != 2 or self.data.shape[1] != 2:
                raise ValueError(f"{self.dtype!r} data must be [n, 2], got "
                                 f"{tuple(self.data.shape)}")
        elif isinstance(self.dtype, T.ArrayType):
            length = self.dtype.length
            if self.data.dim() != 2 or self.data.shape[1] != length:
                raise ValueError(f"{self.dtype!r} data must be [n, "
                                 f"{length}], got {tuple(self.data.shape)}")
        elif self.data.dim() != 1:
            raise ValueError(f"data must be 1-d, got {tuple(self.data.shape)}")
        if self.dtype.variable_width:
            o = self.offsets
            if o is None or o.dtype != torch.int32 or \
                    o.shape != (self.validity.shape[0] + 1,):
                raise ValueError(f"{self.dtype!r} column needs int32 offsets "
                                 f"[{self.validity.shape[0] + 1}]")
        elif self.offsets is not None:
            raise ValueError(f"{self.dtype!r} column takes no offsets")
        elif self.validity.shape[0] != self.data.shape[0]:
            raise ValueError(f"data {tuple(self.data.shape)} and validity "
                             f"{tuple(self.validity.shape)} must be [n] and [n]")

    @property
    def num_rows(self) -> int:
        return self.validity.shape[0]

    @property
    def device(self) -> torch.device:
        return self.validity.device

    @property
    def is_string(self) -> bool:
        return self.offsets is not None

    @property
    def is_two_limb(self) -> bool:
        return T.two_limbs(self.dtype)

    @property
    def is_wide(self) -> bool:
        """A fixed-stride row of several elements: a Decimal128's two
        limbs or a fixed-length array's elements (``data`` [n, w])."""
        return self.data.dim() == 2

    def byte_tile(self, width: int) -> torch.Tensor:
        """uint8 [n, width] of a STRING column: row i's first ``width``
        bytes, zero past its end (the plain versions' view of the
        rows)."""
        off = self.offsets.to(torch.int64)
        pos = torch.arange(width, device=off.device)
        if self.data.shape[0] == 0:   # every row empty: nothing to read
            return torch.zeros((off.shape[0] - 1, width), dtype=torch.uint8,
                               device=off.device)
        idx = (off[:-1, None] + pos).clamp(max=max(self.data.shape[0] - 1, 0))
        inside = pos < (off[1:] - off[:-1])[:, None]
        return torch.where(inside, self.data[idx], 0)

    def slice_rows(self, start: int, end: int) -> "DeviceColumn":
        """Rows [start, end) as views of this column's tensors."""
        if self.is_string:
            return DeviceColumn(self.data, self.validity[start:end],
                                self.dtype, self.offsets[start:end + 1])
        return DeviceColumn(self.data[start:end], self.validity[start:end],
                            self.dtype)

    @staticmethod
    def from_numpy(values: np.ndarray, dtype: T.DataType,
                   validity: Optional[np.ndarray] = None,
                   device="cpu") -> "DeviceColumn":
        """Host -> device upload of a fixed-width column ([n, 2] limbs for
        a Decimal128); null slots are zeroed."""
        vals = np.ascontiguousarray(values, dtype=dtype.np_dtype)
        if validity is None:
            valid = np.ones(vals.shape[:1], np.bool_)
        else:
            valid = np.ascontiguousarray(validity, dtype=np.bool_)
            vals = np.where(valid.reshape(-1, *[1] * (vals.ndim - 1)), vals,
                            np.zeros((), vals.dtype))
        return DeviceColumn(torch.from_numpy(vals).to(device),
                            torch.from_numpy(valid).to(device), dtype)

    @staticmethod
    def from_pylist(values: Sequence, dtype: T.DataType,
                    device="cpu") -> "DeviceColumn":
        """Host -> device upload of a fixed-width column from Python values
        (None is null); a decimal's values are its unscaled ints (a
        ``decimal.Decimal`` is taken at its value)."""
        n = len(values)
        valid = np.fromiter((v is not None for v in values), np.bool_, n)
        if isinstance(dtype, T.DecimalType):
            ints = [0 if v is None else _unscaled(v, dtype.scale)
                    for v in values]
            if dtype.uses_two_limbs:
                vals = np.array([const128(v) for v in ints],
                                np.int64).reshape(n, 2)
            else:
                vals = np.array(ints, np.int64)
        else:
            vals = np.array([0 if v is None else v for v in values],
                            dtype=dtype.np_dtype)
        return DeviceColumn.from_numpy(vals, dtype, valid, device)

    @staticmethod
    def from_string_buffers(offsets: np.ndarray, data: np.ndarray,
                            validity: np.ndarray,
                            device="cpu") -> "DeviceColumn":
        """Host -> device upload of a STRING column from Arrow-style
        buffers; a null row must already have length 0."""
        def upload(a, dt):   # a writable contiguous copy where needed
            return torch.from_numpy(np.require(a, dt, "CW")).to(device)
        return DeviceColumn(upload(data, np.uint8), upload(validity, np.bool_),
                            T.STRING, upload(offsets, np.int32))

    @staticmethod
    def from_strings(values: Sequence[Optional[str]],
                     device="cpu") -> "DeviceColumn":
        """Host -> device upload of a STRING column (None is null)."""
        encoded = [b"" if v is None else
                   (v if isinstance(v, bytes) else v.encode("utf-8"))
                   for v in values]
        lengths = np.fromiter((len(b) for b in encoded), np.int64,
                              len(encoded))
        offsets = np.zeros(len(encoded) + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        if offsets[-1] >= 2**31:
            raise ValueError("a string column holds < 2**31 bytes")
        valid = np.fromiter((v is not None for v in values), np.bool_,
                            len(encoded))
        data = np.frombuffer(b"".join(encoded), np.uint8)
        return DeviceColumn.from_string_buffers(offsets, data, valid, device)

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """Device -> host: owning (values, validity) numpy copies of a
        fixed-width column."""
        if self.is_string:
            raise TypeError("to_numpy takes a fixed-width column; use "
                            "string_buffers")
        return self.data.cpu().numpy().copy(), self.validity.cpu().numpy().copy()

    def string_buffers(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Device -> host of a STRING column: (int32 offsets rebased to
        start at 0, the rows' uint8 bytes, validity)."""
        off = self.offsets.cpu().numpy().astype(np.int64)
        base, end = int(off[0]), int(off[-1])
        data = self.data[base:end].cpu().numpy()
        return ((off - base).astype(np.int32), data,
                self.validity.cpu().numpy().copy())

    def to_pylist(self) -> List:
        """Host values of the column (None for null); strings decode as
        UTF-8, a Decimal128 row is its unscaled Python int."""
        if self.is_two_limb:
            vals, valid = self.to_numpy()
            return [to_python(lo, hi) if ok else None
                    for (lo, hi), ok in zip(vals.tolist(), valid)]
        if not self.is_string:
            vals, valid = self.to_numpy()
            return [v if ok else None for v, ok in zip(vals.tolist(), valid)]
        off, data, valid = self.string_buffers()
        raw = data.tobytes()
        return [raw[off[i]:off[i + 1]].decode("utf-8") if valid[i] else None
                for i in range(len(valid))]
