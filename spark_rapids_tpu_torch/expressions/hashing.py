"""The hash expressions: ``hash()``, ``xxhash64()`` and ``hive_hash()``.

Counterpart of ``spark_rapids_tpu/expressions/hashing.py`` (``_HashBase``
:22, ``Murmur3Hash`` :74, ``XxHash64`` :89, ``HiveHash`` :159, ``hive_hash``
:184): a row hash over any number of columns, never null.  ``hash`` is
Spark's Murmur3_x86_32 and ``xxhash64`` its XXH64, both with seed 42 unless
given; ``hive_hash`` has no seed.  Each runs one kernel of
``kernels/hash.py`` over all of its columns (murmur3, H1 ``xxhash64``, H2
``hive_hash``).  A Decimal128 input to ``xxhash64`` and any decimal input
to ``hive_hash`` raise, as the reference's kernels do.
``BloomFilterMightContain`` (:104) is the probe half of the runtime
filter: its filter is a host ``PyBloomFilter`` (``DataFrame.build_bloom``,
or ``kernels/bloom.py`` ``deserialize`` of Spark's wire bytes), packed
into int64 words and uploaded once per expression and device; each batch
runs B2 ``bloom_probe``.  A null input gives null (:135-137).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.core import (
    EvalContext, Expression, UnaryExpression, col, make_column)
from spark_rapids_tpu_torch.kernels import bloom as BK
from spark_rapids_tpu_torch.kernels import hash as HK


class _HashBase(Expression):
    SEED = 42
    OUT: T.DataType = T.INT

    def __init__(self, *children: Expression, seed: Optional[int] = None):
        if not children:
            raise ValueError(f"{type(self).__name__} needs at least one input")
        self.children = tuple(children)
        self.seed = self.SEED if seed is None else int(seed)

    def with_children(self, children):
        return type(self)(*children, seed=self.seed)

    @property
    def dtype(self):
        return self.OUT

    def _hash(self, cols) -> torch.Tensor:
        raise NotImplementedError

    def eval(self, ctx: EvalContext):
        h = self._hash([c.eval(ctx) for c in self.children])
        return make_column(h, torch.ones(ctx.num_rows, dtype=torch.bool,
                                         device=ctx.device), self.OUT)

    def __repr__(self):
        return (f"{type(self).__name__.lower()}"
                f"({', '.join(map(repr, self.children))})")


class Murmur3Hash(_HashBase):
    """Spark hash(...): Murmur3_x86_32, seed 42."""

    OUT = T.INT

    def _hash(self, cols):
        return HK.murmur3_hash(cols, seed=self.seed)


class XxHash64(_HashBase):
    """Spark xxhash64(...): XXH64, seed 42."""

    OUT = T.LONG

    def _hash(self, cols):
        return HK.xxhash64(cols, seed=self.seed)


class HiveHash(_HashBase):
    """Spark hive_hash(...): Hive's bucketing hash, no seed."""

    OUT = T.INT

    def __init__(self, *children: Expression, seed: Optional[int] = None):
        super().__init__(*children, seed=0)

    def _hash(self, cols):
        return HK.hive_hash(cols)

    def __repr__(self):
        return f"hive_hash({', '.join(map(repr, self.children))})"


class BloomFilterMightContain(UnaryExpression):
    """might_contain(<built filter>, value): the probe half of the
    runtime-filter pair (GpuBloomFilterMightContain.scala)."""

    def __init__(self, child: Expression, bloom: BK.PyBloomFilter):
        super().__init__(child)
        self.bloom = bloom
        #: the filter's words, uploaded once per device
        self._words: Dict[torch.device, torch.Tensor] = {}

    def with_children(self, children):
        out = BloomFilterMightContain(children[0], self.bloom)
        out._words = self._words     # the same filter: share its uploads
        return out

    @property
    def dtype(self):
        return T.BOOLEAN

    def words(self, device: torch.device) -> torch.Tensor:
        if device not in self._words:
            self._words[device] = torch.from_numpy(
                self.bloom.words()).to(device)
        return self._words[device]

    def eval(self, ctx: EvalContext):
        c = self.child.eval(ctx)
        hit = BK.bloom_probe(self.words(c.device), c, self.bloom.k)
        return make_column(hit, c.validity, T.BOOLEAN)

    def __repr__(self):
        return f"might_contain({self.child!r})"


def _cols(cols):
    return [col(c) if isinstance(c, str) else c for c in cols]


def hash(*cols) -> Murmur3Hash:   # noqa: A001 (Spark's name)
    return Murmur3Hash(*_cols(cols))


def xxhash64(*cols) -> XxHash64:
    return XxHash64(*_cols(cols))


def hive_hash(*cols) -> HiveHash:
    return HiveHash(*_cols(cols))
