"""Device column of the port: exact-size tensors.

Counterpart of ``spark_rapids_tpu/columnar/column.py`` (``DeviceColumn``
:42), fixed-width layout only.  The reference pads every column to a
power-of-two capacity and carries a dynamic row count, because XLA needs
static shapes.  PyTorch runs eagerly, so a column here is exactly
``data[n]`` plus ``validity[n]`` (bool, True = non-null), and the row count
is the host int ``n``.  Null slots hold zero, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T


@dataclasses.dataclass
class DeviceColumn:
    data: torch.Tensor       # [n] of dtype.torch_dtype
    validity: torch.Tensor   # [n] bool
    dtype: T.DataType

    def __post_init__(self):
        if self.data.dtype != self.dtype.torch_dtype:
            raise TypeError(f"{self.dtype!r} column needs "
                            f"{self.dtype.torch_dtype}, got {self.data.dtype}")
        if self.validity.dtype != torch.bool:
            raise TypeError(f"validity must be bool, got {self.validity.dtype}")
        if self.data.dim() != 1 or self.validity.shape != self.data.shape:
            raise ValueError(f"data {tuple(self.data.shape)} and validity "
                             f"{tuple(self.validity.shape)} must be [n] and [n]")

    @property
    def num_rows(self) -> int:
        return self.data.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @staticmethod
    def from_numpy(values: np.ndarray, dtype: T.DataType,
                   validity: Optional[np.ndarray] = None,
                   device="cpu") -> "DeviceColumn":
        """Host -> device upload; null slots are zeroed."""
        vals = np.ascontiguousarray(values, dtype=dtype.np_dtype)
        if validity is None:
            valid = np.ones(vals.shape, np.bool_)
        else:
            valid = np.ascontiguousarray(validity, dtype=np.bool_)
            vals = np.where(valid, vals, np.zeros((), vals.dtype))
        return DeviceColumn(torch.from_numpy(vals).to(device),
                            torch.from_numpy(valid).to(device), dtype)

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        """Device -> host: owning (values, validity) numpy copies."""
        return self.data.cpu().numpy().copy(), self.validity.cpu().numpy().copy()
