"""Planner: logical plan -> physical exec tree.

Counterpart of ``spark_rapids_tpu/planner/overrides.py`` (``plan_query``
:1147, ``PlanMeta.convert`` :753 with ``Expand`` :808, ``Union`` :823 and
``Limit`` :826, ``_convert_join`` :945-1020, ``_convert_aggregate``
:1022-1042, ``_exchange`` :1044, ``_estimate_rows`` :1063,
``_plan_partitions`` :1090-1135, ``_insert_aqe_readers`` :1218,
``_tag_window`` :861-931, ``_convert_window`` :933-943, ``Range`` :815,
``Repartition`` :828-830) for InMemoryRelation, Project, Filter,
Aggregate, Join, Sort, Limit, Expand, Union, Window, Range and
Repartition.

- Over more than one partition an aggregate is split in two: a partial
  aggregate, an exchange (one partition for a global aggregate; a hash
  exchange on the group keys into ``spark.sql.shuffle.partitions`` for a
  grouped one), then the final aggregate.
- A join picks its strategy from the build (right) side's estimated rows,
  as the reference does, and carries its residual condition into whichever
  join it becomes.  Over a multi-partition stream side, a build of
  at most ``spark.rapids.sql.join.broadcastRowThreshold`` rows is a
  broadcast hash join, and one within 8x of it (with
  ``spark.rapids.sql.join.adaptive.enabled``) an adaptive join that
  decides at run time; a right or full join never broadcasts (its build
  is the side it null-extends).  Any other join is a shuffled hash join,
  with a hash exchange on the keys under each side where either side has
  more than one partition; a cross or keyless join that does not
  broadcast collapses both sides to one partition
  (``GpuSinglePartitionExec``, the reference's cartesian shape).  A cross
  join with a condition is a Filter over the product; a keyless join of
  another type without a condition raises with the reference's reason
  (its tag, :633-637).
- A union's partitions are its children's, one after another (its
  partition count is their sum); an expand runs each batch once per
  projection, and neither is a stage of a fused segment.
- A window over more than one partition reads a hash exchange on its
  partition keys into ``spark.sql.shuffle.partitions`` (a single-partition
  exchange where it has none), so that each task holds whole window
  partitions.  What the reference tags "will NOT work" and runs on its CPU
  raises NotImplementedError here with the same reason: a bounded RANGE
  frame over anything but one ascending INT, LONG, DATE or TIMESTAMP key,
  FIRST / LAST / NTH_VALUE over strings, a function or input type not
  ported.
  One difference: the reference refuses a Window node whose expressions'
  specs differ by ``repr``, which holds the frame, so its frames of one
  (partition, order) pair run on its CPU; its exec reads each
  expression's own frame, and the port, which has no CPU fallback,
  compares only (partition_by, order_by).
- ``repartition(n, keys...)`` is a hash exchange on the keys (a key the
  hash does not take raises "partition key ... not supported yet", the
  reference's tag :720-724), ``repartition(n)`` a round-robin exchange;
  neither gets a coalesced reader.  ``range`` is ``GpuRangeExec``, in
  batches of ``batchSizeRows``.
- A global sort over more than one partition is a range sort
  (``GpuRangeSortExec``, the reference's :831-840) into
  min(``spark.sql.shuffle.partitions``, the child's partitions)
  partitions; an input of at most ``batchSizeRows`` rows sorts whole into
  its first partition.  A sort within partitions, and a global sort over
  one partition, is ``GpuSortExec``, out of core past ``batchSizeRows``
  rows.  A limit takes the first rows across partitions.
- After conversion, with
  ``spark.rapids.sql.adaptive.coalescePartitions.enabled``, the hash
  exchange under a final aggregate is read through a coalesced reader, and
  the two under a shuffled join through two readers that share one spec.
- Then, with ``spark.rapids.sql.tpu.fuseStages`` (the default), each
  fusable chain of Project / Filter / partial aggregate becomes one fused
  segment (``plan/fused.py``, the reference's ``fuse_segments`` pass at
  :1163-1172).

Before conversion, every expression of the plan is tagged as the
reference's ``PlanMeta`` tags it (:357-415 and the signatures of
``planner/typesig.py`` :204, :272-303) for the string functions and the
conditionals: NULLIF, GREATEST and LEAST over strings (:371), an input
outside an op's signature, a pattern outside the
regex dialect (``RegexUnsupported``), a non-literal STARTSWITH / ENDSWITH
/ CONTAINS pattern, a non-ASCII pad string and CONCAT_WS over a
non-string raise NotImplementedError with the reference's reason (its
planner falls back to its CPU), and so does a cast outside
``Cast.supported`` (:354-356; FLOAT or DOUBLE -> STRING is one, which the
reference gates behind ``castFloatToString``).  The tags that exist only
for XLA's static buckets (``_regex_child_ok``, the repeat and pad bounds,
the string cast over a growing string, :357-362) are not ported: the
string kernels size every output by count-then-allocate, and a cast over
``concat(...)`` runs on the card.  The reference's tag of a hash over a
DOUBLE on the TPU (:433: no raw float64 bits there) has no counterpart:
the card hashes a double's own bits.  ``might_contain`` probes a LONG
only (:425-431); ``approx_count_distinct`` takes integral, DATE,
TIMESTAMP and BOOLEAN input only (:660-668: a STRING or float input
raises with the reference's reason, since the port has no CPU to fall
back to), and grouped it needs ``batchSizeRows * 2^p <= 2^26`` register
slots (:669-675).  The datetime functions, the hashes
and the arithmetic and conditional rest (:100-126, :174-180) need no tag:
a cast to or from TIMESTAMP other than DATE <-> TIMESTAMP raises through
``Cast.supported``, a decimal input to a hash that takes none where its
kernel's wrapper checks it.

Planning never asks an adaptive join or a coalesced reader for its
partition count: that would run the build side or the map side.  The
partition counts it needs come from ``_plan_partitions``, which answers
from the plan's shape.  A plan node the port has no exec for raises
NotImplementedError naming it: there is no CPU fallback.
"""
from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.config import RapidsConf
from spark_rapids_tpu_torch.expressions import strings as S
from spark_rapids_tpu_torch.expressions.aggregates import (
    ApproximateCountDistinct, Count, Max, Min)
from spark_rapids_tpu_torch.expressions.casts import Cast, not_supported
from spark_rapids_tpu_torch.expressions.conditional import (
    CaseWhen, Greatest, If, Least, NullIf)
from spark_rapids_tpu_torch.expressions.core import BoundReference, Literal
from spark_rapids_tpu_torch.expressions.hashing import BloomFilterMightContain
from spark_rapids_tpu_torch.expressions.window import (FirstValue, LastValue,
                                                       NthValue,
                                                       WindowFunction)
from spark_rapids_tpu_torch.kernels import hash as HK
from spark_rapids_tpu_torch.kernels.sort import _kind
from spark_rapids_tpu_torch.plan import logical as L
from spark_rapids_tpu_torch.plan.execs.aggregate import GpuHashAggregateExec
from spark_rapids_tpu_torch.plan.execs.base import GpuExec
from spark_rapids_tpu_torch.plan.execs.basic import (GpuFilterExec,
                                                     GpuProjectExec,
                                                     GpuUnionExec)
from spark_rapids_tpu_torch.plan.execs.exchange import (
    GpuCoalescedShuffleReaderExec, GpuShuffleExchangeExec,
    GpuSinglePartitionExec, SharedCoalesceSpec)
from spark_rapids_tpu_torch.plan.execs.join import (
    GpuAdaptiveJoinExec, GpuBroadcastHashJoinExec, GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.plan.execs.misc import (GpuExpandExec,
                                                    GpuRangeExec)
from spark_rapids_tpu_torch.plan.execs.range_sort import GpuRangeSortExec
from spark_rapids_tpu_torch.plan.execs.scan import GpuInMemoryScanExec
from spark_rapids_tpu_torch.plan.execs.sort import GpuLimitExec, GpuSortExec
from spark_rapids_tpu_torch.plan.execs.window import (WINDOW_AGGREGATES,
                                                      GpuWindowExec, unwrap)
from spark_rapids_tpu_torch.plan.fused import fuse_segments
from spark_rapids_tpu_torch.planner.optimizer import (prune_columns,
                                                      push_filters)

_BROADCASTABLE = ("inner", "left", "left_semi", "left_anti", "cross",
                  "existence")


def _convert(p: L.LogicalPlan, conf: RapidsConf,
             device: torch.device) -> GpuExec:
    if isinstance(p, L.InMemoryRelation):
        return GpuInMemoryScanExec(p.partitions, p.schema)
    if isinstance(p, L.Project):
        return GpuProjectExec(p.exprs, _convert(p.child, conf, device),
                              p.schema)
    if isinstance(p, L.Filter):
        return GpuFilterExec(p.condition, _convert(p.child, conf, device))
    if isinstance(p, L.Aggregate):
        return _convert_aggregate(p, conf, device)
    if isinstance(p, L.Join):
        return _convert_join(p, conf, device)
    if isinstance(p, L.Sort):
        child = _convert(p.child, conf, device)
        nparts = _plan_partitions(child)
        if p.global_sort and nparts > 1:
            return GpuRangeSortExec(
                p.orders, child, min(conf.shuffle_partitions, nparts),
                small_sort_rows=conf.batch_size_rows)
        return GpuSortExec(p.orders, child, target_rows=conf.batch_size_rows)
    if isinstance(p, L.Limit):
        return GpuLimitExec(p.n, _convert(p.child, conf, device))
    if isinstance(p, L.Expand):
        return GpuExpandExec(p.projections, _convert(p.child, conf, device),
                             p.schema)
    if isinstance(p, L.Union):
        return GpuUnionExec(tuple(_convert(c, conf, device)
                                  for c in p.children), p.schema)
    if isinstance(p, L.Window):
        return _convert_window(p, conf, device)
    if isinstance(p, L.Range):
        return GpuRangeExec(p.start, p.end, p.step, p.num_partitions,
                            p.schema, device, conf.batch_size_rows)
    if isinstance(p, L.Repartition):
        return GpuShuffleExchangeExec(p.num_partitions, p.keys,
                                      _convert(p.child, conf, device))
    raise NotImplementedError(f"no exec for {type(p).__name__} in the port")


def _estimate_rows(p: L.LogicalPlan) -> int:
    """The reference's crude cardinality estimate for the join choice: a
    filter halves, an aggregate thirds, a limit caps, a join takes its
    larger side, a union sums its children."""
    if isinstance(p, L.InMemoryRelation):
        return sum(b.num_rows for part in p.partitions for b in part)
    if isinstance(p, L.Filter):
        return max(_estimate_rows(p.child) // 2, 1)
    if isinstance(p, L.Aggregate):
        return max(_estimate_rows(p.child) // 3, 1)
    if isinstance(p, L.Limit):
        return min(p.n, _estimate_rows(p.child))
    if isinstance(p, L.Join):
        return max(_estimate_rows(p.left), _estimate_rows(p.right))
    if isinstance(p, L.Union):
        return sum(_estimate_rows(c) for c in p.children)
    if p.children:
        return _estimate_rows(p.children[0])
    return 1 << 62


def _plan_partitions(node: GpuExec) -> int:
    """A node's partition count from the plan's shape alone: an adaptive
    join keeps at least its shuffle partitions whichever way it decides,
    a union sums its children's, a reader or a join delegates to its first
    child, and only a node that owns its partitioning (a scan, an
    exchange, a limit) is asked."""
    if isinstance(node, GpuAdaptiveJoinExec):
        return max(_plan_partitions(node.children[0]),
                   node.shuffle_partitions)
    if isinstance(node, GpuUnionExec):
        return sum(_plan_partitions(c) for c in node.children)
    if isinstance(node, (GpuCoalescedShuffleReaderExec,
                         GpuShuffledHashJoinExec, GpuBroadcastHashJoinExec)):
        return _plan_partitions(node.children[0])
    if node.children and \
            type(node).num_partitions is GpuExec.num_partitions:
        return _plan_partitions(node.children[0])
    return node.num_partitions()


def _convert_join(p: L.Join, conf: RapidsConf,
                  device: torch.device) -> GpuExec:
    if not p.left_keys and p.join_type != "cross" and p.condition is None \
            and p.join_type != "existence":
        raise NotImplementedError(
            f"keyless {p.join_type} join without a condition (use cross "
            "join)")
    left = _convert(p.left, conf, device)
    right = _convert(p.right, conf, device)
    nparts = conf.shuffle_partitions
    est = _estimate_rows(p.right)
    thr = conf.broadcast_row_threshold
    multi = _plan_partitions(left) > 1
    broadcastable = p.join_type in _BROADCASTABLE
    # cross keeps Spark's Filter-over-product shape
    cross_cond = p.join_type == "cross" and p.condition is not None
    join_cond = None if cross_cond else p.condition
    if broadcastable and multi and est <= thr:
        join: GpuExec = GpuBroadcastHashJoinExec(
            left, right, p.left_keys, p.right_keys, p.join_type, p.schema,
            target_rows=conf.batch_size_rows, condition=join_cond)
        return GpuFilterExec(p.condition, join) if cross_cond else join
    if (broadcastable and multi and p.left_keys and p.join_type != "cross"
            and est <= thr * 8 and conf.join_adaptive_enabled):
        return GpuAdaptiveJoinExec(
            left, right, p.left_keys, p.right_keys, p.join_type, p.schema,
            broadcast_threshold=thr, shuffle_partitions=nparts,
            target_rows=conf.batch_size_rows,
            aqe_coalesce=conf.aqe_coalesce_partitions, condition=p.condition)
    if p.join_type == "cross" or not p.left_keys:
        # candidate pairs must see every right row: both sides collapse to
        # one partition
        if _plan_partitions(left) > 1:
            left = GpuSinglePartitionExec(left)
        if _plan_partitions(right) > 1:
            right = GpuSinglePartitionExec(right)
    elif _plan_partitions(left) > 1 or _plan_partitions(right) > 1:
        # co-partition both sides on the join keys
        left = GpuShuffleExchangeExec(nparts, p.left_keys, left)
        right = GpuShuffleExchangeExec(nparts, p.right_keys, right)
    join = GpuShuffledHashJoinExec(left, right, p.left_keys, p.right_keys,
                                   p.join_type, p.schema,
                                   target_rows=conf.batch_size_rows,
                                   condition=join_cond)
    return GpuFilterExec(p.condition, join) if cross_cond else join


def _convert_aggregate(p: L.Aggregate, conf: RapidsConf,
                       device: torch.device) -> GpuExec:
    child = _convert(p.child, conf, device)
    target = conf.batch_size_rows
    if _plan_partitions(child) == 1:
        return GpuHashAggregateExec(p.group_exprs, p.agg_exprs, p.aggregates,
                                    child, p.schema, device, mode="complete",
                                    target_rows=target)
    partial = GpuHashAggregateExec(p.group_exprs, p.agg_exprs, p.aggregates,
                                   child, p.schema, device, mode="partial",
                                   target_rows=target)
    if p.group_exprs:
        # the partial output's leading columns are the keys _k0, _k1, ...
        key_refs = [BoundReference(i, e.dtype, f"_k{i}")
                    for i, e in enumerate(p.group_exprs)]
        exchange: GpuExec = GpuShuffleExchangeExec(conf.shuffle_partitions,
                                                   key_refs, partial)
    else:
        exchange = GpuSinglePartitionExec(partial)
    return GpuHashAggregateExec(p.group_exprs, p.agg_exprs, p.aggregates,
                                exchange, p.schema, device, mode="final",
                                target_rows=target)


#: the order keys a bounded RANGE frame searches (csrc/window.cu)
_RANGE_KEY_TYPES = (T.IntegerType, T.LongType, T.DateType,
                    T.TimestampType)


def _window_input_ok(fn, dt: T.DataType) -> bool:
    """SUM / AVG over any integral, bool or float input, MIN / MAX over
    bool, INT, DATE, LONG, FLOAT and DOUBLE (``frame_extreme``'s types);
    no decimal or string."""
    if isinstance(dt, T.DecimalType) or dt.variable_width:
        return False
    if isinstance(fn, (Min, Max)):
        return dt.torch_dtype in (torch.bool, torch.int32, torch.int64,
                                  torch.float32, torch.float64)
    return dt.is_integral or dt.is_floating or isinstance(dt, T.BooleanType)


def _tag_window(p: L.Window) -> None:
    """Raise NotImplementedError, with the reference's reason, for what
    the window exec does not run."""
    spec = p.spec
    for what, exprs in (("partition", spec.partition_by),
                        ("order", [e for e, _ in spec.order_by])):
        for e in exprs:
            try:
                _kind(e.dtype)
            except (TypeError, NotImplementedError):
                raise NotImplementedError(
                    f"window {what} key {e!r} not supported yet") from None
    pair = (repr(spec.partition_by), repr(spec.order_by))
    for e in p.window_exprs:
        we = unwrap(e)
        if (repr(we.spec.partition_by), repr(we.spec.order_by)) != pair:
            raise NotImplementedError("mixed window specs in one Window node")
        fn, frame = we.function, we.spec.frame
        bounded_range = frame.kind == "range" and not (
            frame.is_unbounded_to_current() or frame.is_unbounded_both())
        ob = we.spec.order_by
        if bounded_range and not (
                len(ob) == 1 and ob[0][1].ascending
                and isinstance(ob[0][0].dtype, _RANGE_KEY_TYPES)):
            raise NotImplementedError(
                f"bounded range frame {frame} needs a single ascending "
                "fixed-width non-float order key")
        if isinstance(fn, (FirstValue, LastValue, NthValue)):
            if fn.child.dtype.variable_width:
                raise NotImplementedError(
                    f"{fn.name} over strings needs offset-aware frame "
                    "gathers (fixed-width inputs only)")
            continue
        if isinstance(fn, WindowFunction):
            continue
        if isinstance(fn, WINDOW_AGGREGATES) and (
                fn.input is None or isinstance(fn, Count)
                or _window_input_ok(fn, fn.input.dtype)):
            continue
        raise NotImplementedError(f"window function {fn!r} not supported")


def _convert_window(p: L.Window, conf: RapidsConf,
                    device: torch.device) -> GpuExec:
    _tag_window(p)
    child = _convert(p.child, conf, device)
    if _plan_partitions(child) > 1:
        child = (GpuShuffleExchangeExec(conf.shuffle_partitions,
                                        p.spec.partition_by, child)
                 if p.spec.partition_by else GpuSinglePartitionExec(child))
    return GpuWindowExec(p.window_exprs, child, p.schema,
                         target_rows=conf.batch_size_rows)


_NUMERIC = ("byte", "short", "int", "long", "float", "double", "decimal64")
#: the reference's COMMON (ORDERED + null), and the two-limb decimals,
#: which the port's If has selected since Decimal128 was ported
_COMMON = _NUMERIC + ("date", "timestamp", "boolean", "string", "null",
                      "decimal128")
_STR = ("string",)
_BOOL = ("boolean",)
_INT = ("int",)
#: (output, inputs) of each string op and conditional, as the reference's
#: ``register`` calls give them; the last input repeats for the rest
_SIGNATURES = {
    **{cls: (_STR, (_STR,)) for cls in (
        S.Upper, S.Lower, S.Trim, S.LTrim, S.RTrim, S.Reverse, S.InitCap,
        S.Empty2Null, S.ConcatStrings, S.Concat, S.ConcatWs, S.Left, S.Right,
        S.Lpad, S.Rpad, S.StringRepeat, S.StringReplace, S.Translate)},
    **{cls: (_INT, (_STR,)) for cls in (
        S.Length, S.Ascii, S.BitLength, S.OctetLength, S.StringInstr,
        S.StringLocate)},
    **{cls: (_BOOL, (_STR,)) for cls in (
        S.StartsWith, S.EndsWith, S.Contains, S.Like, S.RLike)},
    If: (_COMMON, ()),
    CaseWhen: (_COMMON, ()),
}


def _atom(dt: T.DataType) -> str:
    if isinstance(dt, T.DecimalType):
        return "decimal128" if T.two_limbs(dt) else "decimal64"
    return type(dt).__name__.removesuffix("Type").lower().replace(
        "integer", "int")


def _tag_expression(e) -> None:
    """Raise NotImplementedError, with the reference's reason, for a
    string op, conditional or cast that the device path does not run."""
    if isinstance(e, Cast) and not Cast.supported(e.child.dtype, e.dtype):
        raise not_supported(e.child.dtype, e.dtype)
    if isinstance(e, BloomFilterMightContain) and \
            not isinstance(e.child.dtype, T.LongType):
        raise NotImplementedError(
            "might_contain probes LONG values (Spark BloomFilterImpl putLong "
            "semantics)")
    if isinstance(e, (NullIf, Greatest, Least)) and \
            e.children[0].dtype.variable_width:
        raise NotImplementedError(
            f"{type(e).__name__} over strings needs the byte-comparator "
            "kernel (CPU bridge covers it)")
    if isinstance(e, S.ConcatWs):
        for c in e.children:
            if not isinstance(c.dtype, T.StringType):
                raise NotImplementedError(f"concat_ws over non-string {c!r}")
    if isinstance(e, (S.StartsWith, S.EndsWith, S.Contains)) and \
            not isinstance(e.right, Literal):
        raise NotImplementedError(
            "non-literal match patterns are not supported yet")
    if isinstance(e, (S.Lpad, S.Rpad)) and any(ord(ch) > 0x7F
                                               for ch in e.pad):
        raise NotImplementedError(
            "non-ASCII pad strings pad by bytes on device (character "
            "padding needs the multi-byte kernel)")
    if isinstance(e, S.RLike) or (isinstance(e, S.Like) and not e._fast):
        from spark_rapids_tpu_torch.regex import RegexUnsupported
        try:
            e._compiled()
        except RegexUnsupported as ex:
            raise NotImplementedError(
                f"pattern {e.pattern!r} outside the supported regex "
                f"dialect: {ex}") from None
    sig = _SIGNATURES.get(type(e))
    if sig is None:
        return
    out, params = sig
    if _atom(e.dtype) not in out:
        raise NotImplementedError(
            f"{type(e).__name__} produces {e.dtype!r}, outside the supported "
            f"output signature [{'+'.join(sorted(out))}]")
    for i, c in enumerate(e.children):
        if not params:
            break
        p = params[min(i, len(params) - 1)]
        if _atom(c.dtype) not in p:
            raise NotImplementedError(
                f"{type(e).__name__}: input {i} is {c.dtype!r}, outside "
                f"the supported signature [{'+'.join(sorted(p))}]")


def _plan_expressions(p: L.LogicalPlan) -> list:
    """The bound expressions a logical node evaluates."""
    out = []
    for attr in ("exprs", "group_exprs", "agg_exprs", "left_keys",
                 "right_keys", "window_exprs", "keys"):
        out += list(getattr(p, attr, ()) or ())
    if getattr(p, "condition", None) is not None:
        out.append(p.condition)
    out += [e for e, _ in getattr(p, "orders", ())]
    for proj in getattr(p, "projections", ()):
        out += list(proj)
    return out


def _tag_node(p: L.LogicalPlan, conf: RapidsConf) -> None:
    """Raise NotImplementedError, with the reference's reason, for a
    partition key the hash does not take and for an approx_count_distinct
    the device HLL does not run."""
    if isinstance(p, L.Repartition):
        for e in p.keys:
            try:
                HK._kind(e.dtype)
            except (TypeError, NotImplementedError):
                raise NotImplementedError(
                    f"partition key {e!r} not supported yet") from None
    if isinstance(p, L.Aggregate):
        for agg in p.aggregates:
            if not isinstance(agg, ApproximateCountDistinct):
                continue
            dt = agg.input.dtype
            if not (dt.is_integral or isinstance(
                    dt, (T.DateType, T.TimestampType, T.BooleanType))):
                raise NotImplementedError(
                    f"approx_count_distinct over {agg.input!r}: device HLL "
                    "hashes long-representable values (strings/floats fall "
                    "back)")
            if p.group_exprs and conf.batch_size_rows * agg.m > (1 << 26):
                raise NotImplementedError(
                    "grouped approx_count_distinct needs batchSizeRows * 2^p "
                    "<= 64M register slots (have "
                    f"{conf.batch_size_rows} * {agg.m}); lower "
                    "spark.rapids.sql.batchSizeBytes/rows")


def tag_plan(p: L.LogicalPlan, conf: RapidsConf) -> None:
    """Tag every node (``_tag_node``) and expression (``_tag_expression``)
    of the plan."""
    _tag_node(p, conf)
    stack = list(_plan_expressions(p))
    while stack:
        e = stack.pop()
        _tag_expression(e)
        stack.extend(e.children)
    for c in p.children:
        tag_plan(c, conf)


def _insert_aqe_readers(root: GpuExec, conf: RapidsConf) -> GpuExec:
    """Wrap the hash exchange under each final aggregate in a coalesced
    reader, and the two under each shuffled join in two readers sharing
    one spec; runs after every structural decision of the planner."""
    if not conf.aqe_coalesce_partitions:
        return root

    def spec() -> SharedCoalesceSpec:
        return SharedCoalesceSpec(conf.batch_size_rows, conf.batch_size_bytes)

    def visit(node: GpuExec) -> None:
        kids = list(node.children)
        if (isinstance(node, GpuHashAggregateExec) and node.mode == "final"
                and isinstance(kids[0], GpuShuffleExchangeExec)):
            kids[0] = GpuCoalescedShuffleReaderExec(kids[0], spec())
        elif (isinstance(node, GpuShuffledHashJoinExec)
              and all(isinstance(k, GpuShuffleExchangeExec) for k in kids)):
            shared = spec()
            kids = [GpuCoalescedShuffleReaderExec(k, shared) for k in kids]
        node.children = tuple(kids)
        for k in node.children:
            visit(k)

    visit(root)
    return root


def plan_query(plan: L.LogicalPlan, conf: RapidsConf,
               device: torch.device) -> GpuExec:
    """Push filters down and prune columns, convert every node to its
    exec, insert the AQE readers, then fuse the stage segments."""
    if not conf.sql_enabled:
        raise NotImplementedError(
            "spark.rapids.sql.enabled=false runs the CPU oracle engine, "
            "which is not ported")
    tag_plan(plan, conf)
    root = _convert(prune_columns(push_filters(plan)), conf, device)
    root = _insert_aqe_readers(root, conf)
    root = fuse_segments(root) if conf.fuse_stages else root
    root.session_timezone = conf.session_timezone   # GpuEngine runs under it
    return root
