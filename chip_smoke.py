#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. device: a CUDA card must exist; prints its name and power limit;
  2. build: compiles the port's CUDA kernels from csrc/ (timed);
  3. kernels: each hand-written kernel against its plain PyTorch version on
     the card: the q6 path's kernels at its shapes (n = 1,048,576;
     selectivities 1.8%, 50% and 0%; 10% nulls; a ragged n = 1,000,003),
     and the q1 path's (murmur3, partition, sort, segmented sum) at
     n = 1,048,576 and 1,000,003 over int32, int64, Decimal64, double and
     bool keys with 10% nulls, -0.0 and NaN and 7, 1,000 and ~n distinct;
     then every kernel at the shapes q1 gives it (the filter's mask, the
     sort of the filtered key and the 8-column gather by its permutation,
     the group boundaries, the segmented sums, the 7-row partial batch's
     hash and partition, the reduce side's concat); each timed shape
     compared before it is timed, with its time, the plain version's, a
     library call's and its bound.  Then the q3 path's kernels: the
     string planes of gather and concat, string murmur3, the string sort
     keys and the string group boundaries at n = 1,048,576 and 1,000,003
     (10% nulls, lengths 0-64, bytes >= 0x80, shared prefixes, "ab" next
     to "ab\0"), and the join's build, probe and expand against builds of
     186, 857 and 100,000 keys with duplicates (int32, int64 and double
     keys with -0.0 and NaN); each also at the shapes q3 gives it (the
     first SF10 store_sales batch against the filtered date_dim and item).
     Then the q25 path's several-key join (build words, probe, and the
     shared expand) bit for bit at n = 1,048,576 and 1,000,003 over two
     int32 keys, int32 with int64, two doubles with -0.0 and NaN, and
     (int, string) with 10% nulls, against builds of 186, 180,000 and
     900,000 rows with duplicates, and timed at q25's two shuffled-join
     shapes.  Then the q72 path's: ``conditional_join_maps`` for all
     seven join types at n = 1,048,576 and 1,000,003 candidates, pass
     rates 0%, 10% and 100%, with left rows that have no candidate and
     dead rows, timed at q72's shape (one of 200 partitions: 72,000 sales
     against 665,550 inventory rows, ~94M candidates, 10% passing); the
     left single-key probe (null stream keys, promotion's 300 keys, double
     keys, an empty build) and the left several-key probe ((int32, int32)
     and (int, string) keys with nulls, an empty build), with the shared
     expand; the gather with -1 indices on int, double and string columns
     and from an empty source.  Then the q14a path's semi and anti
     joins: the one-key probes (int32, int64 with Long.MAX_VALUE and
     Long.MIN_VALUE, doubles with -0.0 and NaN, 10% nulls; builds of 186
     and 100,000 keys, an empty build, keys all null) and the several-key
     probes (q14a's item triples with 5% nulls a key, against 72,006 and
     186 rows; (int, string) with nulls; an empty build; triples all
     null) at n = 1,048,576 and 1,000,003 and on an empty stream, each
     with the left-only expand: offsets, counts and the kept rows bit for
     bit, the int cases also against numpy's np.isin; timed at q14a's
     first cross-channel join (144,004 store triples against 72,006
     catalog triples, one of 200 partitions) and at the semi_anti path's
     one-key joins.  Then the q19 path's ``substring`` (UTF-8 characters)
     bit for bit (offsets, bytes, validity) at n = 1,048,576, 1,000,003
     and 0: strings of 0-16 characters of 1-4 bytes (at most 64 bytes),
     10% nulls, 2% of the characters a lone continuation byte, and edge
     rows; every pos in {-70, -3, -1, 0, 1, 2, 5, 100} against every len
     in {-1, 0, 1, 3, 5, 2**30, 2**31 - 1, absent} as literals, and both
     as per-row columns; the same on a slice whose offsets start past 0;
     timed at 1,048,576 five-byte zips (and at q19's shape once phase 7
     has drawn store_sales).  Then the fused
     segment's interpreter
     (``fused_segment``) in both modes against its plain version: a
     program of every instruction over int32 and int64 near their limits,
     doubles with NaN, -0.0 and infinities, bools, decimals at scales 0, 2
     and 4 and dates (10% nulls) at n = 1,048,576, 1,000,003 and 0, with
     filters keeping 0%, 1.8%, 50% and 100% and with none, and a program
     of OR and NOT over bools with nulls: outputs, maps,
     counts and int64 sums bit for bit, f64 sums within 1e-12; then q6's
     program (global) and q1's (compact) on the first SF10 batch, timed.
     Then the MIN / MAX and M2 kernels (``segmented_extreme``,
     ``masked_extreme``, ``segmented_m2``, ``masked_m2``) over bool,
     int32, date, int64, Decimal64, float and double (10% nulls; NaN,
     infinities and both zeros among the floats) at n = 0, 1, 1,048,576
     and 1,000,003, in segments of one row, of 7 (one all null, one all
     NaN, one NaN first, one NaN last), of all rows and ~1,000 random
     ones: extremes and counts bit for bit, M2 (update, and the merge of
     the partials in groups of 5 and to one) within 1e-12 relative; the
     large-mean case of tests/test_variance.py:20 at 1,048,576 rows
     against numpy; each timed at phase 12's partial shape (f64
     [1,048,576], 14 segments).  Then the picks and bitwise reductions
     (``segmented_pick``, ``masked_pick``, ``segmented_bitwise``,
     ``masked_bitwise``) bit for bit at n = 1,048,576, 1,000,003 and 0, in
     14 segments and in ~n/2 of one or two rows (one all null; 10% nulls,
     ties): first / last with and without ignore_nulls; min / max keys
     over bool, int8, int16, int32, int64, float and double (NaN,
     infinities, both zeros) in both NaN modes, and over strings of 0-64
     bytes with binaryCompare's edges ("ab" beside "ab\0", "" beside
     "a"); AND / OR / XOR at every integral width; each timed at phase
     13's partial shape (1,048,576 rows of the tail's table, 9 segments).
     Then the Decimal128 kernels bit for bit (limbs and validity):
     ``decimal128_binary`` at n = 1,000,003 and 0 over one- and
     two-limb operands of every magnitude with +-(10**38 - 1), -2**127
     and 2**127 - 1: add and subtract with rescales, the checked
     multiply, rescales by 10**0..10**38, the cast to double, under
     every precision mode; ``decimal128_divide`` with shifts 0, 13 and
     40, zero divisors, ties of +-0.5 ulp, per-row counts and rescales
     down by 10**1..10**38; ``segmented_sum128`` / ``masked_sum128`` and
     ``segmented_extreme128`` / ``masked_extreme128`` at n = 0, 1 and
     1,000,003 over segments of one row, of 7 (one all
     null), ~1,000 random and ~80,000 rows, sums past int128 and past the
     precision, a merge's poison; each timed at its path's shape
     (q1_decimal's multiply and partial, the held table's a / c, global
     sum and extremes).  Then the window kernels (``window_layout``,
     ``frame_sum_count``, ``range_frame_bounds``, ``frame_extreme``) at
     n = 0, 1 and 1,048,576 over partitions of one row, of all rows and
     ~1,000 random ones with peer runs (1,000,003: the random ones):
     layouts, counts, int64 sums (at the limits, wrapping), RANGE bounds
     (int32 and int64 keys with ties, at the types' ends, a null key's
     zero first) and MIN / MAX over bool, int32, int64, float and double
     (NaN, infinities and both zeros; int64 and double alone over the
     one-row and one-partition layouts at full size) bit for bit, f64
     sums within 1e-12 of the prefix's sum of |x|, over ROWS frames
     (clamped, empty, unbounded), the running and whole frames and random
     ones; each timed at phase 16's shapes (its largest task partition,
     2,045,868 rows in 3 partitions, for the layout, W5's avg(x) sums and
     W6's RANGE bounds; one key's 681,956 rows for a running MIN, which
     torch.cummin computes as one call).
     A kernel's ``max_abs_err`` is the largest difference over all its
     comparisons;
  4. data: TPC-H lineitem at SF10 (60,012,150 rows, all eleven columns on
     the card, batches of 1,048,576 rows, 4 partitions), with independent
     numpy evaluations of q6 and q1;
  5. q6 through GpuSession, held against numpy, with every q6 kernel's
     launch count checked over that run, then timed, then profiled for
     the card's busy time and idle share: fused (the default; the fused
     kernel once a batch, no compaction or gather) and with
     ``spark.rapids.sql.tpu.fuseStages=false`` (the filter's compaction,
     gather and masked sum), each with its launches and device
     activities a batch;
  6. q1 the same two ways: grouped partial aggregate, hash exchange into
     16 partitions, final aggregate; then phase 14 over the same data;
  7. q3 at TPC-DS SF10 (store_sales 28,800,991 rows, all twelve columns on
     the card, batches of 1,048,576 rows, 4 partitions; item 102,000
     rows; date_dim 2,190 rows): two broadcast hash joins, the grouped
     aggregate on (d_year, i_brand_id, i_brand) across the hash exchange,
     ORDER BY over a single-partition exchange; held against an
     independent numpy evaluation (same groups, same order), then timed
     and profiled as q1.  Its pass over store_sales also collects the
     zips of the rows of store_sales' first partition that reach q19's
     filter (one call of q19's main path), at which ``substring`` is held
     against its plain version and timed for the kernels line;
  8. q25 at TPC-DS SF10 (store_sales as in phase 7; store_returns
     2,875,432 rows, 90% copied from sales; catalog_sales 14,401,261 rows,
     70% copied from the returns' (customer, item) pairs; all on the card,
     4 partitions each; item 102,000 rows, store 50, date_dim 2,190): the
     adaptive join of store_sales with store_returns (it must go
     shuffled), the planned shuffled join with catalog_sales through
     coalesced readers sharing one spec (every shuffled join must take the
     streamed probe; the largest build partition of each is printed), five
     broadcast dimension joins, the grouped sums on four keys (three
     strings) across the hash exchange, ORDER BY and LIMIT 100; held
     against an independent numpy evaluation (packed int64 keys, sort and
     searchsorted joins, integer-cent sums), then timed and profiled;
     then TPC-DS q17 on the same tables and session (the chain with
     d1 2001 months 1-3, d2 and d3 2001 months 1-9, grouped by item id,
     description and store name: count, avg, stddev_samp and
     stddev_samp / avg of the three quantities; the segmented M2 update
     and merge on its path), its 100 rows and then every group without
     LIMIT against numpy (counts exact, means, standard deviations and
     ratios within 1e-9 of numpy's two-pass float64, null exactly below
     two rows), timed and profiled;
     then q6, q1, q3 and q25 fused against ``fuseStages=false`` in 6
     alternating pairs each (medians, quartiles, pairs won);
  9. q72 at TPC-DS SF10 in a session of 200 shuffle partitions with the
     coalesced reader off: catalog_sales as in phase 8; inventory
     133,110,000 rows (102,000 items, 10 warehouses), catalog_returns
     1,439,749 (60% copied from the sales' (item, order) pairs), 4
     partitions each, all on the card; item 102,000 rows, date_dim 2,190,
     warehouse 10, promotion 300, customer_demographics 1,000,
     household_demographics 100.  The inventory join must be a shuffled
     join with its condition that took the streamed probe in all 200
     partitions, the catalog_returns join an adaptive left join that went
     shuffled, promotion a broadcast left join; the 100 rows must equal
     an independent numpy evaluation exactly and in order (the filters
     first, an (item, week) join of packed int64 keys by sort and
     searchsorted, the return counts); the main-path run is traced for
     the card's busy time (no run of its own: q72 takes ~25 s), then
     timed by one more run (so is q14a's: the script's time limit);
 10. q14a, q5 and the semi_anti path at TPC-DS SF10 in the session of
     phase 9: the channel sales (store 28,800,991 rows, catalog
     14,401,261, web 7,197,566) and returns (2,875,432, 1,439,749 and
     719,217), six and five columns, 4 partitions each, all on the card;
     item 102,000 rows, date_dim 2,190.  q14a runs with its scalar
     subquery live: the card's mean price must agree with numpy's within
     1e-12 relative with no price between the two; its nine semi joins
     must be shuffled joins that took the streamed probe in all 200
     partitions; its rows must equal an independent numpy evaluation
     (item triples packed into int64, the semi joins as np.isin, the
     rollup in integer cents) in order, counts exact, sums within 1e-9.
     q5 (the unions of each channel's sales and returns, the date join,
     the rollup on (channel, id)) the same way.  The semi_anti path (the
     store sales of a hot item by a one-key semi join, not sold in 2000 by
     a one-key anti join, whose item triple the web did not sell in
     January 2000 by an adaptive three-key anti join that broadcasts)
     against numpy's count and cents.  Each with its launches, then timed
     and profiled as q72 (q5 and semi_anti by the median of 3 runs);
 11. q42, q52, q55, q96, q7, q26 and q19 at TPC-DS SF10 in the session
     of phase 7 (16 shuffle partitions, every join broadcast):
     store_sales and catalog_sales as phases 7 and 8 left them on the
     card; item 102,000 rows, date_dim 2,190, time_dim 86,400; the
     dimensions the fact generators draw keys for at the reference
     generators' sizes, cut from real SF10 (in brackets): customer 50,000
     (500,000), customer_address 25,000 (250,000), store 50 (102),
     customer_demographics 1,000 (1,920,800), household_demographics 100
     (7,200), promotion 300 (500).  Each query against an independent
     numpy evaluation (dimensions as arrays by key, the filters as boolean
     arrays, sums in integer cents): its groups, its counts exact, its
     sums and averages within 1e-9, in its order (groups numpy's exact
     sums tie may trade places); q19 must launch ``substring`` and never
     call ``substring_plain``.  Each with its launches, timed (median of
     3 after the traced main-path run) and profiled;
 12. the held aggregate shapes (``testing/held.py``: tests/test_queries.py's
     table, k INT of 13 keys, v LONG, x DOUBLE with NaN, +inf and -0.0
     at rows 0-2, f FLOAT, b BOOLEAN, n // 7 nulls each) at 15,003,037
     rows in batches of 1,048,576, 16 partitions: the global and grouped
     aggregates of test_queries.py, MIN / MAX of every column, the four
     variances of x and v, global and grouped, and a global MIN / MAX /
     M2 after a filter, which must be one fused segment; each against
     numpy (MIN / MAX, keys, counts and integer sums exact, the rest
     within 1e-9, NaN where numpy has NaN), with its launches, timed and
     profiled;
 13. the aggregate tail (``testing/held.py`` ``tail_columns``:
     tests/test_agg_tail.py's table, k INT of 9 keys, v LONG, x DOUBLE
     with NaN, -0.0 and +inf at rows 0-2, s STRING of 95 distinct values
     (3-8 bytes), b BYTE, n // 6 nulls each in v, x, s and b) at
     15,003,037 rows (a quarter of SF10 lineitem's, for the script's
     time) in batches of 1,048,576, 16 partitions, fused by default:
     grouped and global FIRST / LAST, grouped MAX_BY / MIN_BY over x and
     over v, MAX_BY / MIN_BY over the STRING s grouped and
     global, grouped STRING MIN / MAX, and the bit aggregates over v and
     b grouped and global; each against numpy in the port's input order
     (values exact, floats bit for bit, NaN equal to NaN), with its
     launches, timed and profiled;
 14. (run right after phase 6) q1_decimal: TPC-H q1 with its decimal
     types (sums decimal(22,2) to decimal(38,6), averages decimal(16,6),
     no cast to DOUBLE) over phase 4's lineitem, every value and count
     of the 7 groups exact against numpy's integers accumulated in
     phase 4's pass; with its launches, timed and profiled;
 15. the held two-limb decimals (``testing/held.py``
     ``decimal_columns``: tests/test_decimal128.py's table, a
     decimal(25,4), b decimal(30,2), c decimal(12,2), k INT of 7 keys,
     n // 9 nulls in a and b) at 8,388,608 rows in batches of
     1,048,576, 8 partitions: add and subtract, the multiply, the mixed
     add, the comparison filter, the casts, the divide, SUM grouped,
     global and past 38 digits, AVG, MIN / MAX grouped and global.  An
     elementwise query's output stays on the card and is held bit for
     bit against the same query run with the plain versions, and at
     100,000 seeded rows against Python ints; an aggregate's rows exact
     against numpy's integer reductions over 32-bit limbs.  Each with
     its launches, timed and profiled;
 16. the held window shapes (``testing/held.py`` ``window_columns``:
     tests/test_window.py's wdf, k INT of 11 keys, t INT 0-39, v LONG and
     x DOUBLE with n // 9 nulls, and the row index i) at 7,501,518 rows
     (an eighth of SF10 lineitem's, for the script's time) in batches of
     1,048,576, 16 partitions: W1 the ranks, W2 the default
     RANGE frame, W3 the whole partition, W4 LEAD / LAG / FIRST / LAST /
     NTH_VALUE, W5 the seven ROWS frames and W6 the six bounded RANGE
     frames of tests/test_window.py, W7 ROW_NUMBER over (t, v) with no
     partition (all rows in one); each run to its device batches, every
     row against numpy in the port's arrival order (exact; W5's float
     frame sums within 1e-9), the whole output against the same plan run
     with the four window kernels' plain versions (bit for bit; W5's
     float frame sums within 1e-12); with its launches, timed and
     profiled;
 17. TPC-DS q98 over phase 11's store_sales, item and date_dim (SF10):
     the window over a string key inside arithmetic, every row against
     numpy's integer cents in order (revenue and ratio within 1e-9), with
     its launches, timed and profiled;
 18. prints the kernels summary line, then the result line last.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import contextlib
import decimal
import json
import os
import statistics
from concurrent.futures import ThreadPoolExecutor
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from spark_rapids_tpu_torch.api.session import (  # noqa: E402
    DataFrame, GpuSession)
from spark_rapids_tpu_torch.columnar.arrow import batch_from_numpy  # noqa: E402
from spark_rapids_tpu_torch.columnar.column import (  # noqa: E402
    DeviceColumn, const128, to_python)
from spark_rapids_tpu_torch.columnar.batch import (  # noqa: E402
    ColumnarBatch, Schema)
from spark_rapids_tpu_torch.expressions.core import EvalContext  # noqa: E402
from spark_rapids_tpu_torch import expressions as E  # noqa: E402
from spark_rapids_tpu_torch.expressions import program as P  # noqa: E402
from spark_rapids_tpu_torch.kernels import _lib  # noqa: E402
from spark_rapids_tpu_torch.kernels import decimal as DK  # noqa: E402
from spark_rapids_tpu_torch.kernels import fused as FK  # noqa: E402
from spark_rapids_tpu_torch.kernels import groupby as G  # noqa: E402
from spark_rapids_tpu_torch.kernels import hash as HK  # noqa: E402
from spark_rapids_tpu_torch.kernels import join as JK  # noqa: E402
from spark_rapids_tpu_torch.kernels import partition as PK  # noqa: E402
from spark_rapids_tpu_torch.kernels import reduction as R  # noqa: E402
from spark_rapids_tpu_torch.kernels import selection as S  # noqa: E402
from spark_rapids_tpu_torch.kernels import sort as SK  # noqa: E402
from spark_rapids_tpu_torch.kernels import strings as SS  # noqa: E402
from spark_rapids_tpu_torch.kernels import window as WK  # noqa: E402
from spark_rapids_tpu_torch.plan.engine import GpuEngine  # noqa: E402
from spark_rapids_tpu_torch.plan.execs.exchange import (  # noqa: E402
    GpuCoalescedShuffleReaderExec)
from spark_rapids_tpu_torch.plan.execs.join import (  # noqa: E402
    GpuAdaptiveJoinExec, GpuBroadcastHashJoinExec, GpuShuffledHashJoinExec)
from spark_rapids_tpu_torch.plan.fused import (  # noqa: E402
    GpuFusedSegmentExec)
from spark_rapids_tpu_torch import types as T  # noqa: E402
from spark_rapids_tpu_torch.testing import held, tpcds, tpch  # noqa: E402

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
# no integer peak is published beside the tensor-core rates: the f32 rate
# outside the tensor cores stands for the 32-bit integer and f64-add work
# (an upper bound on the rate, so the bound stays a lower bound on time)
OPS_PER_S = 67e12
N = 1 << 20                      # rows per batch on the q6 path
RAGGED = 1_000_003
SEL_Q6 = 0.018                   # q6's selectivity on this generator
SF10_ROWS = 10 * tpch.ROWS_PER_SF
F64_RTOL_KERNEL = 1e-12          # sum order differs from torch.sum
F64_RTOL_Q6 = 1e-9               # against numpy's pairwise sum
F64_RTOL_Q1 = 1e-9               # against numpy's bincount sums
Q1_CUTOFF = tpch._days(1998, 9, 2)
SHUFFLE_PARTITIONS = 16
ITERS, WARMUP = 20, 3
AB_PAIRS = 6

KERNELS = {
    "compaction_map": ("csrc/selection.cu",
                       "spark_rapids_tpu/kernels/selection.py:65"),
    "gather": ("csrc/selection.cu",
               "spark_rapids_tpu/kernels/selection.py:191"),
    "masked_sum": ("csrc/reduction.cu",
                   "spark_rapids_tpu/plan/execs/aggregate.py:274"),
    "concat": ("csrc/selection.cu",
               "spark_rapids_tpu/kernels/selection.py:429"),
    "murmur3": ("csrc/hash.cu", "spark_rapids_tpu/kernels/hash.py:237"),
    "partition": ("csrc/sort.cu",
                  "spark_rapids_tpu/kernels/partition.py:27"),
    "sort": ("csrc/sort.cu", "spark_rapids_tpu/kernels/sort.py:200"),
    "segmented_sum": ("csrc/reduction.cu",
                      "spark_rapids_tpu/kernels/groupby.py:166"),
    "gather_strings": ("csrc/selection.cu",
                       "spark_rapids_tpu/kernels/selection.py:160"),
    "concat_strings": ("csrc/selection.cu",
                       "spark_rapids_tpu/kernels/selection.py:429"),
    "hash_string": ("csrc/hash.cu", "spark_rapids_tpu/kernels/hash.py:187"),
    "string_sort_keys": ("csrc/strings.cu",
                         "spark_rapids_tpu/kernels/sort.py:160"),
    "string_rows_equal_prev": ("csrc/strings.cu",
                               "spark_rapids_tpu/kernels/groupby.py:74"),
    "join_build": ("csrc/join.cu", "spark_rapids_tpu/kernels/join.py:154"),
    "join_probe": ("csrc/join.cu", "spark_rapids_tpu/kernels/join.py:154"),
    "join_expand": ("csrc/join.cu", "spark_rapids_tpu/kernels/join.py:226"),
    "join_multi_build": ("csrc/join.cu",
                         "spark_rapids_tpu/kernels/join.py:275"),
    "join_multi_probe": ("csrc/join.cu",
                         "spark_rapids_tpu/kernels/join.py:275"),
    "conditional_join_maps": ("csrc/join.cu",
                              "spark_rapids_tpu/kernels/join.py:44"),
    "join_probe_left": ("csrc/join.cu",
                        "spark_rapids_tpu/kernels/join.py:203"),
    "join_multi_probe_left": ("csrc/join.cu",
                              "spark_rapids_tpu/kernels/join.py:395"),
    "gather_null_extend": ("csrc/selection.cu",
                           "spark_rapids_tpu/kernels/selection.py:308"),
    "fused_segment": ("csrc/fused.cu", "spark_rapids_tpu/plan/fused.py:943"),
    "join_probe_semi": ("csrc/join.cu",
                        "spark_rapids_tpu/kernels/join.py:197"),
    "join_probe_anti": ("csrc/join.cu",
                        "spark_rapids_tpu/kernels/join.py:197"),
    "join_multi_probe_semi": ("csrc/join.cu",
                              "spark_rapids_tpu/kernels/join.py:397"),
    "join_multi_probe_anti": ("csrc/join.cu",
                              "spark_rapids_tpu/kernels/join.py:397"),
    "join_expand_left_only": ("csrc/join.cu",
                              "spark_rapids_tpu/kernels/join.py:212"),
    "substring": ("csrc/strings.cu",
                  "spark_rapids_tpu/kernels/strings.py:161"),
    "segmented_extreme": ("csrc/reduction.cu",
                          "spark_rapids_tpu/kernels/groupby.py:228"),
    "masked_extreme": ("csrc/reduction.cu",
                       "spark_rapids_tpu/plan/execs/aggregate.py:292"),
    "segmented_m2": ("csrc/reduction.cu",
                     "spark_rapids_tpu/kernels/groupby.py:179"),
    "masked_m2": ("csrc/reduction.cu",
                  "spark_rapids_tpu/plan/execs/aggregate.py:318"),
    "segmented_pick": ("csrc/reduction.cu",
                       "spark_rapids_tpu/kernels/groupby.py:419"),
    "masked_pick": ("csrc/reduction.cu",
                    "spark_rapids_tpu/kernels/groupby.py:496"),
    "segmented_bitwise": ("csrc/reduction.cu",
                          "spark_rapids_tpu/kernels/groupby.py:448"),
    "masked_bitwise": ("csrc/reduction.cu",
                       "spark_rapids_tpu/kernels/groupby.py:528"),
    "decimal128_binary": ("csrc/decimal.cu",
                          "spark_rapids_tpu/kernels/decimal.py:237"),
    "decimal128_divide": ("csrc/decimal.cu",
                          "spark_rapids_tpu/kernels/decimal.py:409"),
    "segmented_sum128": ("csrc/reduction.cu",
                         "spark_rapids_tpu/kernels/decimal.py:293"),
    "masked_sum128": ("csrc/reduction.cu",
                      "spark_rapids_tpu/kernels/decimal.py:304"),
    "segmented_extreme128": ("csrc/reduction.cu",
                             "spark_rapids_tpu/kernels/decimal.py:315"),
    "masked_extreme128": ("csrc/reduction.cu",
                          "spark_rapids_tpu/plan/execs/aggregate.py:147"),
    "window_layout": ("csrc/window.cu",
                      "spark_rapids_tpu/kernels/window.py:45"),
    "frame_sum_count": ("csrc/window.cu",
                        "spark_rapids_tpu/kernels/window.py:255"),
    "range_frame_bounds": ("csrc/window.cu",
                           "spark_rapids_tpu/kernels/window.py:216"),
    "frame_extreme": ("csrc/window.cu",
                      "spark_rapids_tpu/kernels/window.py:268"),
}
FUSE_OFF = {"spark.rapids.sql.tpu.fuseStages": "false"}
# fused (the default), q6's filter and partial sum are one kernel a batch:
# the final aggregate's concat and masked sum remain
Q6_KERNELS = ("fused_segment", "masked_sum", "concat")
Q6_UNFUSED_KERNELS = ("compaction_map", "gather", "masked_sum", "concat")
Q1_UNFUSED_KERNELS = ("compaction_map", "gather", "concat", "murmur3",
                      "partition", "sort", "segmented_sum")
Q1_KERNELS = Q1_UNFUSED_KERNELS + ("fused_segment",)
Q3_KERNELS = ("fused_segment", "compaction_map", "gather", "gather_strings",
              "concat", "concat_strings", "murmur3", "hash_string",
              "partition", "sort",
              "string_sort_keys", "string_rows_equal_prev", "segmented_sum",
              "join_build", "join_probe", "join_expand")
Q25_KERNELS = Q3_KERNELS + ("join_multi_build", "join_multi_probe")
SS_ROWS = tpcds.SF10_STORE_SALES_ROWS
SR_ROWS = tpcds.SF10_STORE_RETURNS_ROWS
CS_ROWS = tpcds.SF10_CATALOG_SALES_ROWS
ITEM_ROWS = tpcds.SF10_ITEM_ROWS
F64_RTOL_Q3 = 1e-9               # against numpy's bincount sums
F64_RTOL_Q25 = 1e-9              # against numpy's integer-cent sums
SS_POOL = ["ss_ticket_number", "ss_item_sk", "ss_customer_sk",
           "ss_sold_date_sk"]
SR_POOL = ["sr_customer_sk", "sr_item_sk", "sr_returned_date_sk"]


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase line carries the script's elapsed seconds."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": time.perf_counter() - T0}
    print(json.dumps(obj), flush=True)


def cuda_ms(fn) -> float:
    """Median time of one call between CUDA events recorded around it."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: the kernel of torch.cuda._sleep (ATen/cuda/Sleep.cu), which each trace
#: of device_profile launches after fn to show that the trace saw the card
SENTINEL = "spin_kernel"

#: device_profile calls whose traces never saw the card (not even the
#: sentinel), timed with CUDA events instead: (fn's name, ms per call)
PROFILER_LOST: list = []


def traced_events(fn, calls: int) -> tuple:
    """(name, ms) of the device activities of ``calls`` calls of fn, and
    whether the trace saw the card: the sentinel spin, launched after the
    calls inside the same trace, is in it (and taken out of the list)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    events = device_events(prof)
    mine = [e for e in events if SENTINEL not in e[0]]
    return mine, len(mine) < len(events)


def events_ms(fn, calls: int) -> float:
    """Time of ``calls`` calls of fn between two CUDA events, per call."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def device_profile(fn, calls: int = ITERS, idle_ok: bool = False,
                   warm: bool = True):
    """Device activity of ``calls`` calls of fn under torch.profiler (CUPTI):
    (device ms per call, device activities per call, device ms by name).
    Device activities are kernels, copies and memsets; their summed
    durations are the time the card worked, whatever the host did.  A
    trace without fn's activity is taken again, three times at most, with
    a growing pause.  If the sentinel is in the last one, fn launched
    nothing: that fails, unless the caller declares (``idle_ok``) that fn
    may launch nothing, as an empty gather does.  If no trace saw even the
    sentinel, CUPTI delivered nothing for a while (it has happened after
    hundreds of traces): fn is then timed between CUDA events, which also
    holds the host's share, and the call returns (that ms, None, {}),
    noted in PROFILER_LOST and on stderr.  ``warm``: one call first,
    outside the trace (a caller that has just run fn passes False)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    for attempt in range(4):
        if attempt:
            time.sleep(0.1 * attempt)
        events, seen = traced_events(fn, calls)
        if seen and (events or idle_ok):
            break
    if not seen:
        ms = events_ms(fn, calls)
        name = getattr(fn, "__qualname__", repr(fn))
        PROFILER_LOST.append((name, ms))
        print(f"chip_smoke: no trace saw the card for {name}; timed with "
              f"CUDA events: {ms} ms a call", file=sys.stderr, flush=True)
        return ms, None, {}
    require(events or idle_ok, "torch.profiler recorded no device "
            "activity for a call that launches work")
    by_name = {}
    for name, ms in events:
        by_name[name] = by_name.get(name, 0.0) + ms / calls
    return sum(by_name.values()), len(events) / calls, by_name


def device_events(prof):
    """(name, ms) of each device activity of a finished trace, read from
    the raw CUPTI records: building the profiler's Python event tree
    takes minutes for a query of ~200,000 kernels (q72)."""
    cuda = torch.autograd.DeviceType.CUDA
    raw = getattr(getattr(prof, "profiler", None), "kineto_results", None)
    if raw is None:
        return [(e.name, e.time_range.elapsed_us() / 1e3)
                for e in prof.events() if e.device_type == cuda]
    out = []
    for e in raw.events():
        if e.device_type() != cuda:
            continue
        ms = (e.duration_ns() / 1e6 if hasattr(e, "duration_ns")
              else e.duration_us() / 1e3)
        out.append((e.name(), ms))
    return out


def measure(kernel, plain, library, nbytes: int, ops: int = 0,
            idle_ok: bool = False) -> dict:
    """Times of the kernel's wrapper, its plain version and the library
    call (None: there is none) on the same inputs: ``*_ms`` is the median
    time of one call between CUDA events, which also holds the host's work
    while the card waits for it; ``*_device_ms`` is the card's own time
    per call (profiler).  ``idle_ok``: the inputs are empty, so a call may
    launch nothing."""
    out = {}
    for key, fn in (("kernel", kernel), ("plain", plain),
                    ("library", library)):
        if fn is None:
            out[f"{key}_ms"] = out[f"{key}_device_ms"] = None
            continue
        out[f"{key}_ms"] = cuda_ms(fn)
        ms, activities, _ = device_profile(fn, idle_ok=idle_ok)
        out[f"{key}_device_ms"] = ms
        if activities is None:
            out[f"{key}_device_ms_from"] = "cuda_events"
    out["bound_us"] = bound_ms(nbytes, ops) * 1e3
    return out


def summarize(line: dict, nbytes: int, ops: int = 0) -> dict:
    """The kernels-line entry: device times, beside the bound.  Its
    ``max_abs_err`` comes from ERRS when the line is printed."""
    return dict(ms=line["kernel_device_ms"],
                ms_from=line.get("kernel_device_ms_from", "profiler"),
                call_ms=line["kernel_ms"],
                plain_ms=line["plain_device_ms"],
                library_ms=line["library_device_ms"],
                bound_ms=bound_ms(nbytes, ops),
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops / OPS_PER_S
                else "operations")


def bound_ms(nbytes: int, ops: int = 0) -> float:
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S) * 1e3


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


#: kernel -> the largest |kernel - plain| over every comparison of phase 3
ERRS: dict = {}


def abs_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over two tensors of one shape and type; NaNs in
    the same places count as equal."""
    if got.numel() == 0:
        return 0.0
    if got.dtype == torch.bool:
        return float((got != want).any())
    if got.is_floating_point():
        same = (got == want) | (torch.isnan(got) & torch.isnan(want))
        d = (got - want).abs().masked_fill(same, 0.0)
        return float(d.max())
    return float((got.to(torch.int64) - want.to(torch.int64)).abs().max())


def hold(kernel: str, pairs, what: str, rtol=None) -> float:
    """Hold each (kernel's tensor, plain version's tensor) pair: bit for bit,
    or within ``rtol`` relative; record the largest absolute error."""
    err = 0.0
    for got, want in pairs:
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"{kernel}: {what}: {tuple(got.shape)} {got.dtype} against "
                f"{tuple(want.shape)} {want.dtype}")
        e = abs_err(got, want)
        if rtol is None:
            ok = torch.equal(bits(got), bits(want))
        else:
            ok = bool(((got - want).abs() <= rtol * want.abs()).all())
        require(ok, f"{kernel} differs from its plain version: {what} "
                f"(max abs err {e})")
        err = max(err, e)
    ERRS[kernel] = max(ERRS.get(kernel, 0.0), err)
    return err


def column_pairs(got, want) -> list:
    return [p for x, y in zip(got, want, strict=True)
            for p in ((x.data, y.data), (x.validity, y.validity))]


def random_column(rng, n, dtype: T.DataType, null_frac: float,
                  dev) -> DeviceColumn:
    if dtype == T.DOUBLE:
        vals = rng.uniform(0.0, 1e5, n)
    elif dtype == T.BOOLEAN:
        vals = rng.rand(n) < 0.5
    elif dtype.torch_dtype == torch.int32:
        vals = rng.randint(-2**31, 2**31 - 1, n, dtype=np.int64)
    else:
        vals = rng.randint(-2**62, 2**62, n, dtype=np.int64)
    valid = rng.rand(n) >= null_frac
    return DeviceColumn.from_numpy(vals.astype(dtype.np_dtype), dtype, valid,
                                   dev)


def bits(t: torch.Tensor) -> torch.Tensor:
    """Floats as their bits, so that NaN equals itself."""
    if not t.is_floating_point():
        return t
    return t.view({2: torch.int16, 4: torch.int32,
                   8: torch.int64}[t.element_size()])


# -- phase 1 ------------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    return smi


# -- phase 2 ------------------------------------------------------------------

def phase_build() -> None:
    t0 = time.perf_counter()
    path = _lib.build()
    _lib.lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path)})


# -- phase 3 ------------------------------------------------------------------

def q1_shapes(dev) -> dict:
    """The shapes q1 gives the kernels, from the first SF10 batch: the
    filter's mask; the partial step's work batch (the int32 key and its
    seven f64 inputs), the key's sort permutation, the group-boundary
    flags and the group starts; and a 7-row partial batch's key, which the
    exchange hashes and partitions."""
    chunk = next(tpch.iter_lineitem(SF10_ROWS, seed=42, batch_rows=N))
    mask = chunk["l_shipdate"] <= Q1_CUTOFF
    key = chunk["l_linenumber"][mask]
    qty, price, disc, tax = (chunk[c][mask].astype(np.float64) / 100 for c in
                             ("l_quantity", "l_extendedprice", "l_discount",
                              "l_tax"))
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    order = np.argsort(key, kind="stable")
    skey = key[order]
    boundary = np.r_[True, skey[1:] != skey[:-1]]
    work = [DeviceColumn.from_numpy(key, T.INT, None, dev)] + [
        DeviceColumn.from_numpy(v, T.DOUBLE, None, dev)
        for v in (qty, price, disc_price, charge, qty, price, disc)]
    return {
        "filter_mask": torch.from_numpy(mask).to(dev),
        "key": work[0],
        "work": work,
        "order": torch.from_numpy(order.astype(np.int32)).to(dev),
        "boundary": torch.from_numpy(boundary).to(dev),
        "sorted_qty": DeviceColumn.from_numpy(qty[order], T.DOUBLE, None,
                                              dev),
        "starts": torch.from_numpy(np.flatnonzero(boundary).astype(
            np.int32)).to(dev),
        "partial_key": DeviceColumn.from_numpy(
            np.arange(1, 8, dtype=np.int32), T.INT, None, dev),
    }


def check_compaction(rng, dev, shapes, summary) -> dict:
    """Random masks at q6's selectivity and others, then q1's filter mask
    (96.5% set) and its group-boundary flags (7 set in ~1.01M)."""
    cases = [(f"p={p}", torch.from_numpy(rng.rand(n) < p).to(dev), (n, p))
             for n, p in ((N, SEL_Q6), (N, 0.5), (N, 0.0), (RAGGED, 0.5))]
    cases += [("q1_filter", shapes["filter_mask"], None),
              ("q1_boundary", shapes["boundary"], None)]
    masks = {}
    for label, mask, key in cases:
        n = mask.shape[0]
        got, count = S.compaction_map(mask)
        want, wcount = S.compaction_map_plain(mask)
        require(count == wcount, f"compaction_map count differs: {label}")
        hold("compaction_map", [(got, want)], f"{label} n={n}")
        lib_idx = torch.nonzero(mask).flatten().to(torch.int32)
        require(torch.equal(got, lib_idx), "compaction_map != torch.nonzero")
        if key is not None:
            masks[key] = (mask, got)
        nbytes = n + 4 * count
        line = {"kernel": "compaction_map", "shape": label, "n": n,
                "count": count, **measure(
                    lambda: S.compaction_map(mask),
                    lambda: S.compaction_map_plain(mask),
                    lambda: torch.nonzero(mask), nbytes)}
        emit(line)
        if key == (N, SEL_Q6):
            summary["compaction_map"] = summarize(line, nbytes)
    return masks


def check_gather(rng, dev, masks, shapes, summary) -> None:
    # q6's four columns after pruning, then the other widths
    q6_types = [tpch.DEC12_2, tpch.DEC12_2, tpch.DEC12_2, T.DATE]
    for (n, p), (_, idx) in masks.items():
        types = q6_types + [T.DOUBLE, T.BOOLEAN, T.INT]
        cols = [random_column(rng, n, dt, 0.1, dev) for dt in types]
        cases = [("map", idx)]
        if p == 0.5:
            oob = torch.tensor([-1, n, 2**31 - 1, 0, n - 1], dtype=torch.int32,
                               device=dev)
            cases.append(("map+out_of_range", torch.cat([idx, oob])))
        for label, ix in cases:
            hold("gather", column_pairs(S.gather_columns(cols, ix),
                                        S.gather_columns_plain(cols, ix)),
                 f"n={n} p={p} {label}")
        q6_cols = cols[:4]
        m = idx.shape[0]
        planes = [t for c in q6_cols for t in (c.data, c.validity)]
        nbytes = 4 * m + 2 * m * sum(c.data.element_size() + 1
                                     for c in q6_cols)
        line = {"kernel": "gather", "shape": f"p={p}", "n_src": n, "rows": m,
                "columns": 4,
                **measure(lambda: S.gather_columns(q6_cols, idx),
                          lambda: S.gather_columns_plain(q6_cols, idx),
                          lambda: [torch.index_select(t, 0, idx)
                                   for t in planes], nbytes,
                          idle_ok=m == 0)}
        emit(line)
        if (n, p) == (N, SEL_Q6):
            summary["gather"] = summarize(line, nbytes)
    # q1's partial step: the 8 work columns by the key's sort permutation
    work, order = shapes["work"], shapes["order"]
    m = order.shape[0]
    hold("gather", column_pairs(S.gather_columns(work, order),
                                S.gather_columns_plain(work, order)),
         f"q1's {len(work)}-column gather by the sort permutation, n={m}")
    planes = [t for c in work for t in (c.data, c.validity)]
    nbytes = 4 * m + 2 * m * sum(c.data.element_size() + 1 for c in work)
    emit({"kernel": "gather", "shape": "q1_sorted", "n_src": m, "rows": m,
          "columns": len(work),
          **measure(lambda: S.gather_columns(work, order),
                    lambda: S.gather_columns_plain(work, order),
                    lambda: [torch.index_select(t, 0, order) for t in planes],
                    nbytes)})


def check_masked_sum(rng, dev, masks, summary) -> None:
    m_q6 = masks[(N, SEL_Q6)][1].shape[0]
    cases = [(m_q6, 0.0), (N, 0.1), (RAGGED, 0.1), (N, 1.0), (0, 0.0), (1, 0.0)]
    for n, null_frac in cases:
        for dt in (T.DOUBLE, T.LONG):
            c = random_column(rng, n, dt, null_frac, dev)
            value, ok, nvalid = R.masked_sum(c.data, c.validity)
            pv, pok, pn = R.masked_sum_plain(c.data, c.validity)
            what = f"n={n} {dt!r}"
            hold("masked_sum", [(ok, pok), (nvalid, pn)], what)
            err = hold("masked_sum", [(value, pv)], what,
                       F64_RTOL_KERNEL if dt == T.DOUBLE else None)
            if n < N and not (n == m_q6 and dt == T.DOUBLE):
                continue
            nbytes = 9 * n + 17
            line = {"kernel": "masked_sum", "dtype": repr(dt), "n": n,
                    "null_frac": null_frac, "abs_err": err,
                    **measure(lambda: R.masked_sum(c.data, c.validity),
                              lambda: R.masked_sum_plain(c.data, c.validity),
                              lambda: torch.sum(c.data), nbytes)}
            emit(line)
            if n == m_q6 and dt == T.DOUBLE:
                summary["masked_sum"] = summarize(line, nbytes)


def check_concat(rng, dev, summary) -> None:
    k = 58   # one-row partials of q6 at SF10
    # q1's reduce side: a partition's pieces, one from each map batch, of
    # one row, or two where two keys share the partition
    cases = [("q6_partials", [1] * k, 0.0), ("q1_partials", [2] * k, 0.0),
             ("ragged", list(rng.randint(0, 20_000, k)), 0.1),
             ("with_empty", [0, 5, 0, 0, 7, 0], 0.1),
             ("one_piece", [RAGGED], 0.1)]
    for label, sizes, null_frac in cases:
        for dt in (T.DOUBLE, T.LONG, T.INT, T.DATE, T.BOOLEAN):
            pieces = [random_column(rng, int(s), dt, null_frac, dev)
                      for s in sizes]
            hold("concat", column_pairs([S.concat_column(pieces)],
                                        [S.concat_column_plain(pieces)]),
                 f"{label} {dt!r}")
        if label != "q6_partials":
            continue
        pieces = [random_column(rng, 1, T.DOUBLE, 0.0, dev) for _ in range(k)]
        hold("concat", column_pairs([S.concat_column(pieces)],
                                    [S.concat_column_plain(pieces)]),
             "the timed pieces")
        nbytes = 2 * 9 * k
        line = {"kernel": "concat", "pieces": k, "rows": k,
                **measure(lambda: S.concat_column(pieces),
                          lambda: S.concat_column_plain(pieces),
                          lambda: (torch.cat([p.data for p in pieces]),
                                   torch.cat([p.validity for p in pieces])),
                          nbytes)}
        emit(line)
        summary["concat"] = summarize(line, nbytes)


SPECIAL_KEYS = np.array([0.0, -0.0, np.nan, -np.nan])


def key_column(rng, n, dtype: T.DataType, distinct: int, dev,
               null_frac: float = 0.1) -> DeviceColumn:
    """n keys drawn from about ``distinct`` values, with nulls; doubles
    take -0.0, 0.0 and NaNs of both signs at 5% of the rows."""
    v = rng.randint(0, distinct, n).astype(np.int64) - distinct // 2
    if dtype == T.BOOLEAN:
        vals = v % 2 == 0
    elif dtype == T.DOUBLE:
        vals = v / 4.0
        special = rng.rand(n) < 0.05
        vals[special] = rng.choice(SPECIAL_KEYS, int(special.sum()))
    elif dtype.torch_dtype == torch.int32:
        vals = v
    else:      # long and Decimal64: wide values, within 18 digits
        vals = v * (2**33 + 7)
    valid = rng.rand(n) >= null_frac
    return DeviceColumn.from_numpy(vals.astype(dtype.np_dtype), dtype, valid,
                                   dev)


KEY_TYPES = (T.INT, T.LONG, tpch.DEC12_2, T.DOUBLE)


def key_cases(n):
    return [(dt, d) for dt in KEY_TYPES for d in (7, 1_000, n)] + [
        (T.BOOLEAN, 2)]


def hold_murmur3(cols, what: str, kernel: str = "murmur3") -> None:
    h, part = HK.murmur3_partition(cols, SHUFFLE_PARTITIONS)
    want = HK.murmur3_hash_plain(cols)
    hold(kernel, [(h, want), (part, HK.pmod(want, SHUFFLE_PARTITIONS))],
         what)


def check_murmur3(rng, dev, shapes, summary) -> None:
    for n in (N, RAGGED):
        for dt, distinct in key_cases(n):
            hold_murmur3([key_column(rng, n, dt, distinct, dev)],
                         f"n={n} {dt!r} distinct={distinct}")
    cols = [key_column(rng, N, dt, 1_000, dev) for dt in KEY_TYPES]
    hold("murmur3", [(HK.murmur3_hash(cols), HK.murmur3_hash_plain(cols))],
         "chained over four columns")
    for label, col in (("n", key_column(rng, N, T.INT, 1_000, dev)),
                       ("q1_partial", shapes["partial_key"])):
        hold_murmur3([col], f"the timed {label} key")
        n = col.num_rows
        # ~25 integer operations per 4-byte block, 3 for pmod
        nbytes, ops = 5 * n + 8 * n, 28 * n
        line = {"kernel": "murmur3", "shape": label, "n": n, "columns": 1,
                **measure(lambda: HK.murmur3_partition([col],
                                                       SHUFFLE_PARTITIONS),
                          lambda: HK.pmod(HK.murmur3_hash_plain([col]),
                                          SHUFFLE_PARTITIONS),
                          None, nbytes, ops)}
        emit(line)
        if label == "q1_partial":
            summary["murmur3"] = summarize(line, nbytes, ops)


def hold_partition(part, nparts: int, what: str) -> None:
    hold("partition", zip(PK.partition_order(part, nparts),
                          PK.partition_order_plain(part, nparts)), what)


def check_partition(rng, dev, shapes, summary) -> None:
    # up to 256 partitions take one radix pass, 257 and 4,096 two, 100,003
    # three
    for n in (N, RAGGED):
        for nparts in (1, 16, 200, 257, 4_096, 100_003):
            part = torch.from_numpy(rng.randint(0, nparts, n).astype(
                np.int32)).to(dev)
            hold_partition(part, nparts, f"n={n} parts={nparts}")
    hold_partition(torch.zeros(0, dtype=torch.int32, device=dev), 1_000,
                   "no rows")
    # the whole hash_partition against its plain pieces on the same tensors
    cols = [key_column(rng, RAGGED, dt, 1_000, dev) for dt in KEY_TYPES]
    batch = ColumnarBatch(tuple(cols), RAGGED, Schema(
        tuple(f"c{i}" for i in range(len(cols))), KEY_TYPES))
    for nparts in (SHUFFLE_PARTITIONS, 1_000):
        got, counts = PK.hash_partition(batch, [0, 3], nparts)
        w_part = HK.pmod(HK.murmur3_hash_plain([cols[0], cols[3]]), nparts)
        w_order, w_counts = PK.partition_order_plain(w_part, nparts)
        what = f"hash_partition over {nparts} partitions"
        hold("partition", [(counts, w_counts)], what)
        hold("gather", column_pairs(got.columns,
                                    S.gather_columns_plain(cols, w_order)),
             what)
    _, big = HK.murmur3_partition([key_column(rng, N, T.INT, 1_000, dev)],
                                  SHUFFLE_PARTITIONS)
    _, small = HK.murmur3_partition([shapes["partial_key"]],
                                    SHUFFLE_PARTITIONS)
    for label, part in (("n", big), ("q1_partial", small)):
        hold_partition(part, SHUFFLE_PARTITIONS, f"the timed {label} ids")
        n = part.shape[0]
        nbytes = 8 * n + 4 * SHUFFLE_PARTITIONS
        line = {"kernel": "partition", "shape": label, "n": n,
                "partitions": SHUFFLE_PARTITIONS, **measure(
                    lambda: PK.partition_order(part, SHUFFLE_PARTITIONS),
                    lambda: PK.partition_order_plain(part,
                                                     SHUFFLE_PARTITIONS),
                    lambda: (torch.sort(part, stable=True),
                             torch.bincount(part,
                                            minlength=SHUFFLE_PARTITIONS)),
                    nbytes)}
        emit(line)
        if label == "q1_partial":
            summary["partition"] = summarize(line, nbytes)


def hold_sort(cols, orders, what: str) -> None:
    batch = ColumnarBatch(tuple(cols), cols[0].num_rows, Schema(
        tuple(f"k{i}" for i in range(len(cols))),
        tuple(c.dtype for c in cols)))
    hold("sort", [(SK.sort_indices(batch, list(range(len(cols))), orders),
                   SK.sort_indices_plain(cols, orders))], what)


def check_sort(rng, dev, shapes, summary) -> None:
    asc = [SK.SortOrder()]
    for n in (N, RAGGED):
        for dt, distinct in key_cases(n):
            orders = asc if distinct != 1_000 else [SK.SortOrder(False)]
            hold_sort([key_column(rng, n, dt, distinct, dev)], orders,
                      f"n={n} {dt!r} distinct={distinct} {orders}")
    hold_sort([key_column(rng, RAGGED, T.INT, 7, dev),
               key_column(rng, RAGGED, T.DOUBLE, 1_000, dev)],
              [SK.SortOrder(True, False), SK.SortOrder(False, True)],
              "two keys")
    long_col = key_column(rng, N, T.LONG, N, dev)
    for label, col in (("n_long_nulls", long_col),
                       ("q1_partial", shapes["key"])):
        hold_sort([col], asc, f"the timed {label} key")
        n = col.num_rows
        batch = ColumnarBatch((col,), n, Schema(("k",), (col.dtype,)))
        nbytes = (col.data.element_size() + 1) * n + 4 * n
        line = {"kernel": "sort", "shape": label, "n": n,
                "dtype": repr(col.dtype), **measure(
                    lambda: SK.sort_indices(batch, [0], asc),
                    lambda: SK.sort_indices_plain([col], asc),
                    lambda: torch.sort(col.data, stable=True), nbytes)}
        emit(line)
        if label == "q1_partial":
            summary["sort"] = summarize(line, nbytes)
    # the permutation q1's gather takes is the sort's
    require(torch.equal(SK.sort_indices(ColumnarBatch(
        (shapes["key"],), shapes["key"].num_rows, Schema(("k",), (T.INT,))),
        [0], asc), shapes["order"]), "q1's sort differs from numpy's")


def hold_segmented_sum(c, st, what: str) -> float:
    got = R.segmented_sum(c.data, c.validity, st)
    want = R.segmented_sum_plain(c.data, c.validity, st)
    hold("segmented_sum", list(zip(got[1:], want[1:])), what)
    return hold("segmented_sum", [(got[0], want[0])], what,
                F64_RTOL_KERNEL if c.data.dtype == torch.float64 else None)


def check_segmented_sum(rng, dev, shapes, summary) -> None:
    for n in (N, RAGGED):
        for g in (7, 1_000, n // 2):
            starts = np.unique(np.r_[0, rng.randint(1, n, g - 1)])
            st = torch.from_numpy(starts.astype(np.int32)).to(dev)
            for dt in (T.DOUBLE, T.LONG):
                c = random_column(rng, n, dt, 0.1, dev)
                if g == 7:   # one segment all null
                    c.validity[starts[3]:starts[4]] = False
                    c.data[starts[3]:starts[4]] = 0
                hold_segmented_sum(c, st, f"n={n} g={g} {dt!r}")
    c, st = shapes["sorted_qty"], shapes["starts"]
    n, g = c.num_rows, st.shape[0]
    lengths = R.segment_rows(st, n)
    err = hold_segmented_sum(c, st, "q1's shape")
    nbytes, ops = 9 * n + 4 * g + 25 * g, 2 * n
    line = {"kernel": "segmented_sum", "shape": "q1_partial", "n": n,
            "segments": g, "abs_err": err, **measure(
                lambda: R.segmented_sum(c.data, c.validity, st),
                lambda: R.segmented_sum_plain(c.data, c.validity, st),
                lambda: torch.segment_reduce(c.data, "sum", lengths=lengths),
                nbytes, ops)}
    emit(line)
    summary["segmented_sum"] = summarize(line, nbytes, ops)


# -- phase 3: MIN / MAX and M2 (q17's and phase 12's paths) --------------------

AGG_TAIL_TYPES = (T.BOOLEAN, T.INT, T.DATE, T.LONG, tpch.DEC12_2, T.FLOAT,
                  T.DOUBLE)
M2_TYPES = (T.INT, T.LONG, T.FLOAT, T.DOUBLE)
F64_RTOL_M2 = 1e-12              # the squares add in another order
PHASE12_GROUPS = 14              # 13 keys and the null key
SPECIAL_FLOATS = (0.0, -0.0, np.nan, np.inf, -np.inf)


def tail_column(rng, n: int, dtype: T.DataType, dev, specials=True,
                null_frac=0.1) -> DeviceColumn:
    """Values of the type, 10% null; floats with NaN, infinities and zeros
    of both signs among them (``specials``)."""
    if dtype in (T.FLOAT, T.DOUBLE):
        vals = rng.randn(n) * 1e3
        if specials:
            pick = rng.rand(n) < 0.08
            vals[pick] = rng.choice(SPECIAL_FLOATS, int(pick.sum()))
    elif dtype == T.BOOLEAN:
        vals = rng.rand(n) < 0.5
    elif dtype.torch_dtype == torch.int32:
        vals = rng.randint(-2**31, 2**31 - 1, n, dtype=np.int64)
    else:
        vals = rng.randint(-2**63, 2**63 - 1, n, dtype=np.int64)
    valid = rng.rand(n) >= null_frac
    vals = np.where(valid, vals.astype(dtype.np_dtype),
                    np.zeros((), dtype.np_dtype))
    return DeviceColumn.from_numpy(vals, dtype, valid, dev)


def tail_layouts(n: int) -> dict:
    """Segment starts: every row alone, runs of 7, one segment of all rows
    (n > 0), and ~1,000 random segments."""
    out = {"whole": np.zeros(1, np.int64)} if n else {}
    out["ones"] = np.arange(n)
    out["sevens"] = np.arange(0, n, 7)
    if n > 1_000:
        rng = np.random.RandomState(n)
        out["random"] = np.unique(np.r_[0, rng.randint(1, n, 999)])
    return out


def with_edge_segments(c: DeviceColumn, starts: np.ndarray) -> DeviceColumn:
    """In runs of 7: segment 0 all null, and for floats segment 1 all NaN,
    segment 2 NaN first, segment 3 NaN last."""
    if len(starts) < 5:
        return c
    c.validity[starts[0]:starts[1]] = False
    c.data[starts[0]:starts[1]] = 0
    if c.data.is_floating_point():
        c.validity[starts[1]:starts[4]] = True
        c.data[starts[1]:starts[2]] = float("nan")
        c.data[starts[2]] = float("nan")
        c.data[starts[4] - 1] = float("nan")
    return c


def hold_extremes(c: DeviceColumn, st: torch.Tensor, what: str) -> None:
    for is_min in (True, False):
        w = f"{what} {'min' if is_min else 'max'}"
        hold("segmented_extreme", list(zip(
            R.segmented_extreme(c.data, c.validity, st, is_min),
            R.segmented_extreme_plain(c.data, c.validity, st, is_min))), w)
        hold("masked_extreme", list(zip(
            R.masked_extreme(c.data, c.validity, is_min),
            R.masked_extreme_plain(c.data, c.validity, is_min))), w)


def hold_m2_pair(kernel: str, got: torch.Tensor, want: torch.Tensor,
                 what: str) -> float:
    """M2 within F64_RTOL_M2 relative, NaN where the plain version is."""
    nan = torch.isnan(want)
    require(torch.equal(torch.isnan(got), nan),
            f"{kernel} differs from its plain version in its NaNs: {what}")
    return hold(kernel, [(got[~nan], want[~nan])], what, F64_RTOL_M2)


def hold_m2(c: DeviceColumn, st: torch.Tensor, what: str) -> None:
    """Update over the column, then merge its per-segment partials (with
    the null ones of segments without a valid row)."""
    x64 = c.data.to(torch.float64)
    total, ok, cnt, _ = R.segmented_sum(x64, c.validity, st)
    args = ("update", c.data, c.validity, st, total, cnt)
    m2 = R.segmented_m2(*args)
    hold_m2_pair("segmented_m2", m2, R.segmented_m2_plain(*args),
                 f"{what} update")
    t1, _, n1 = R.masked_sum(x64, c.validity)
    args1 = ("update", c.data, c.validity, t1, n1)
    hold_m2_pair("masked_m2", R.masked_m2(*args1), R.masked_m2_plain(*args1),
                 f"{what} update")
    g = st.shape[0]
    if g == 0:
        return
    # the partials merged in groups of 5 segments, and all to one
    m2 = torch.where(ok, m2, torch.zeros((), dtype=m2.dtype, device=m2.device))
    st5 = torch.arange(0, g, 5, dtype=torch.int32, device=st.device)
    all_ok = torch.ones_like(ok)
    t5, _, _, _ = R.segmented_sum(total, ok, st5)
    n5 = R.segmented_sum(cnt, all_ok, st5)[0]
    args5 = ("merge", m2, ok, st5, t5, n5, total, cnt)
    hold_m2_pair("segmented_m2", R.segmented_m2(*args5),
                 R.segmented_m2_plain(*args5), f"{what} merge")
    tm, _, _ = R.masked_sum(total, ok)
    nm = R.masked_sum(cnt, all_ok)[0]
    argsm = ("merge", m2, ok, tm, nm, total, cnt)
    hold_m2_pair("masked_m2", R.masked_m2(*argsm), R.masked_m2_plain(*argsm),
                 f"{what} merge")


def phase12_layout(rng, n: int, dev):
    """A partial step's work at phase 12's shape: a batch's double column
    sorted by its 13 keys and the null key (14 segments)."""
    keys = np.sort(rng.randint(0, PHASE12_GROUPS, n))
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    c = tail_column(rng, n, T.DOUBLE, dev, specials=False, null_frac=1 / 7)
    st = torch.from_numpy(starts.astype(np.int32)).to(dev)
    return c, st


def check_agg_tail(rng, dev, summary) -> None:
    """segmented_extreme, masked_extreme, segmented_m2 and masked_m2
    against their plain versions: every type of the slice's paths, n = 0,
    1, 1,048,576 and 1,000,003, segments of one row, of 7 (one all null,
    one all NaN, one NaN first, one NaN last) and of all rows, ~1,000
    random ones; extremes and counts bit for bit, M2 within 1e-12; the
    large-mean case of tests/test_variance.py:20; then each timed at
    phase 12's shape."""
    for n in (0, 1, N, RAGGED):
        for name, starts in tail_layouts(n).items():
            st = torch.from_numpy(starts.astype(np.int32)).to(dev)
            for dt in AGG_TAIL_TYPES:
                c = tail_column(rng, n, dt, dev)
                if name == "sevens":
                    c = with_edge_segments(c, starts)
                what = f"n={n} {name} {dt!r}"
                hold_extremes(c, st, what)
                if dt in M2_TYPES:
                    hold_m2(c, st, what)
    # mean >> stddev: 1e8 + (i % 7) - 3 in three segments
    i = np.arange(N)
    big = DeviceColumn.from_numpy(1.0e8 + (i % 7) - 3.0, T.DOUBLE, None, dev)
    st3 = torch.tensor([0, N // 3, 2 * N // 3], dtype=torch.int32, device=dev)
    hold_m2(big, st3, "large mean")
    total, _, cnt, _ = R.segmented_sum(big.data, big.validity, st3)
    m2 = R.segmented_m2("update", big.data, big.validity, st3, total, cnt)
    want = [np.var((1.0e8 + (i % 7) - 3.0)[a:b]) * (b - a) for a, b in
            zip((0, N // 3, 2 * N // 3), (N // 3, 2 * N // 3, N))]
    require(np.allclose(m2.cpu().numpy(), want, rtol=1e-9),
            f"large-mean M2 {m2.tolist()} against numpy {want}")
    c, st = phase12_layout(rng, N, dev)
    g = st.shape[0]
    lengths = R.segment_rows(st, N)
    total, _, cnt, _ = R.segmented_sum(c.data, c.validity, st)
    t1, _, n1 = R.masked_sum(c.data, c.validity)
    cases = {
        "segmented_extreme": (
            lambda: R.segmented_extreme(c.data, c.validity, st, True),
            lambda: R.segmented_extreme_plain(c.data, c.validity, st, True),
            lambda: torch.segment_reduce(c.data, "min", lengths=lengths),
            9 * N + 4 * g + 9 * g),
        "masked_extreme": (
            lambda: R.masked_extreme(c.data, c.validity, True),
            lambda: R.masked_extreme_plain(c.data, c.validity, True),
            lambda: torch.amin(c.data), 9 * N + 17),
        "segmented_m2": (
            lambda: R.segmented_m2("update", c.data, c.validity, st, total,
                                   cnt),
            lambda: R.segmented_m2_plain("update", c.data, c.validity, st,
                                         total, cnt),
            None, 9 * N + 4 * g + 16 * g + 8 * g),
        "masked_m2": (
            lambda: R.masked_m2("update", c.data, c.validity, t1, n1),
            lambda: R.masked_m2_plain("update", c.data, c.validity, t1, n1),
            lambda: torch.var(c.data), 9 * N + 16 + 8),
    }
    hold_extremes(c, st, "phase 12's shape")
    hold_m2(c, st, "phase 12's shape")
    for kernel, (fn, plain, library, nbytes) in cases.items():
        line = {"kernel": kernel, "shape": "phase12_partial", "n": N,
                "segments": g, **measure(fn, plain, library, nbytes, N)}
        emit(line)
        summary[kernel] = summarize(line, nbytes, N)


# -- phase 3: the q3 path's string and join kernels ----------------------------

def string_column(rng, n, dev, null_frac=0.1, lo=0, hi=64,
                  shared=0.5) -> DeviceColumn:
    """n strings of lo..hi random bytes (>= 0x80 included), null_frac
    nulls; a ``shared`` share of the rows starts with one of 16 12-byte
    prefixes."""
    lengths = rng.randint(lo, hi + 1, n)
    valid = rng.rand(n) >= null_frac
    lengths[~valid] = 0
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    total = int(offsets[-1])
    data = rng.randint(0, 256, total).astype(np.uint8)
    row = np.repeat(np.arange(n), lengths)
    pos = np.arange(total) - offsets[:-1][row]
    pool = rng.randint(0, 256, (16, 12)).astype(np.uint8)
    pick = rng.randint(0, 16, n)
    m = (pos < 12) & (rng.rand(n) < shared)[row]
    data[m] = pool[pick[row[m]], pos[m]]
    return DeviceColumn.from_string_buffers(offsets.astype(np.int32), data,
                                            valid, dev)


#: the edge cases of binaryCompare, hashing and equality, appended to the
#: random columns
STRING_EDGES = ["ab", "ab\x00", "ab\x00\x00", "", None, "\xff", "\x80",
                "ab", "abcdefgh", "abcdefgh\x00", "abcdefghi", "ABC",
                "é" * 20, None, ""]


def with_edges(col: DeviceColumn, dev) -> DeviceColumn:
    return S.concat_column_plain([col, DeviceColumn.from_strings(STRING_EDGES,
                                                                 dev)])


def string_pairs(got: DeviceColumn, want: DeviceColumn) -> list:
    """A string column's planes, its offsets rebased to 0."""
    def rebased(c):
        o = c.offsets.to(torch.int64)
        return (o - o[0]).to(torch.int32), c.data[int(o[0]):int(o[-1])]
    (go, gd), (wo, wd) = rebased(got), rebased(want)
    return [(go, wo), (gd, wd), (got.validity, want.validity)]


def any_pairs(got, want) -> list:
    out = []
    for x, y in zip(got, want, strict=True):
        out += string_pairs(x, y) if y.is_string else column_pairs([x], [y])
    return out


def to_device(b: ColumnarBatch, dev) -> ColumnarBatch:
    return ColumnarBatch(tuple(
        DeviceColumn(c.data.to(dev), c.validity.to(dev), c.dtype,
                     None if c.offsets is None else c.offsets.to(dev))
        for c in b.columns), b.num_rows, b.schema)


def q3_tables():
    """The dimension tables at SF10, on the host: date_dim's (sk, year,
    moy) and item's (sk, brand_id, manufact_id, category_id, brand) as
    numpy arrays."""
    date = tpcds.gen_date_dim("cpu")
    item = tpcds.gen_item("cpu", ITEM_ROWS)
    d = {n: date.column(n).to_numpy()[0]
         for n in ("d_date_sk", "d_year", "d_moy")}
    i = {n: item.column(n).to_numpy()[0]
         for n in ("i_item_sk", "i_brand_id", "i_manufact_id",
                   "i_category_id")}
    i["i_brand"] = np.array(item.column("i_brand").to_pylist(), dtype=object)
    return date, item, d, i


def q3_shapes(dev, tables) -> dict:
    """The shapes q3 gives its kernels, from the first SF10 store_sales
    batch: the first join (1,048,576 stream keys against date_dim's 186
    ``d_moy = 11`` keys), the second (its ~89,000 pairs against item's
    ~857 ``i_manufact_id = 28`` keys), the partial aggregate's keys
    (d_year, i_brand_id, i_brand) of the ~750 joined rows, and the reduce
    side's string pieces (28 views of those keys)."""
    date, item, d, i = tables
    data, _ = next(tpcds.iter_store_sales(SS_ROWS, ITEM_ROWS, batch_rows=N))
    keep_d = np.flatnonzero(d["d_moy"] == 11)
    keep_i = np.flatnonzero(i["i_manufact_id"] == 28)
    build1 = S.gather_batch(date.select(["d_date_sk", "d_year", "d_moy"]),
                            torch.from_numpy(keep_d.astype(np.int32)))
    build2 = S.gather_batch(item.select(["i_item_sk", "i_brand_id", "i_brand",
                                         "i_manufact_id"]),
                            torch.from_numpy(keep_i.astype(np.int32)))
    date_sk = data["ss_sold_date_sk"]
    li1 = np.flatnonzero(d["d_moy"][date_sk - 2450000] == 11)
    item_sk = data["ss_item_sk"][li1]
    li2 = np.flatnonzero(i["i_manufact_id"][item_sk - 1] == 28)
    # the build rows the second join pairs them with
    ri2 = np.searchsorted(keep_i, item_sk[li2] - 1).astype(np.int32)
    rows = li1[li2]
    brand = i["i_brand"][item_sk[li2] - 1]
    keys = [DeviceColumn.from_numpy(d["d_year"][date_sk[rows] - 2450000],
                                    T.INT, None, dev),
            DeviceColumn.from_numpy(i["i_brand_id"][item_sk[li2] - 1], T.INT,
                                    None, dev),
            DeviceColumn.from_strings(list(brand), dev)]
    order = np.lexsort((brand.astype(str), keys[1].data.cpu().numpy(),
                        keys[0].data.cpu().numpy()))
    sorted_brand = DeviceColumn.from_strings(list(brand[order]), dev)
    rng = np.random.RandomState(7)
    pieces = [keys[2].slice_rows(s, s + 37)
              for s in rng.randint(0, max(len(rows) - 37, 1), 28)]
    return {
        "stream1": DeviceColumn.from_numpy(date_sk, T.INT, None, dev),
        "build1": to_device(build1, dev),
        "stream2": DeviceColumn.from_numpy(item_sk, T.INT, None, dev),
        "build2": to_device(build2, dev),
        "ri2": torch.from_numpy(ri2).to(dev),
        "pairs1": len(li1), "pairs2": len(li2),
        "partial_keys": keys,
        "sorted_brand": sorted_brand,
        "reduce_pieces": pieces,
    }


def gather_bytes(cols, ix: torch.Tensor) -> int:
    """What a gather of in-range rows must move: the map, then per column
    its planes read and written once (a string row: its two offsets and
    validity read, its offset and validity written, its bytes read and
    written)."""
    m = ix.shape[0]
    total = 4 * m
    for c in cols:
        if c.is_string:
            lengths = (c.offsets[1:] - c.offsets[:-1]).to(torch.int64)
            total += 14 * m + 2 * int(lengths[ix.long()].sum())
        else:
            total += 2 * (c.data.element_size() + 1) * m
    return total


def check_string_gather(rng, dev, q3, summary) -> None:
    for n in (N, RAGGED):
        for lo, hi in ((0, 8), (0, 64), (64, 128)):   # 1, 8, 32 lanes
            sc = with_edges(string_column(rng, n, dev, lo=lo, hi=hi), dev)
            m = sc.num_rows
            cols = [random_column(rng, m, T.INT, 0.1, dev), sc,
                    random_column(rng, m, T.DOUBLE, 0.1, dev)]
            perm = torch.from_numpy(rng.permutation(m).astype(np.int32)).to(dev)
            rep = torch.from_numpy(rng.randint(-3, m + 3, m // 3).astype(
                np.int32)).to(dev)
            for label, ix in (("permutation", perm), ("repeats+oob", rep),
                              ("empty", perm[:0])):
                got = S.gather_columns(cols, ix)
                want = S.gather_columns_plain(cols, ix)
                hold("gather_strings", string_pairs(got[1], want[1]),
                     f"n={m} lengths {lo}-{hi} {label}")
                hold("gather", column_pairs([got[0], got[2]],
                                            [want[0], want[2]]),
                     f"beside strings n={m} {label}")
    # a 1,048,576-row string column by a permutation, and q3's shape: the
    # second join's build side (item, i_brand a string) by its map
    big = string_column(rng, N, dev, null_frac=0.1, lo=0, hi=64)
    perm = torch.from_numpy(rng.permutation(N).astype(np.int32)).to(dev)
    b2, ri2 = q3["build2"], q3["ri2"]
    for label, cols, ix in (("n_0-64", [big], perm),
                            ("q3_join2_build", list(b2.columns), ri2)):
        hold("gather_strings", any_pairs(S.gather_columns(cols, ix),
                                         S.gather_columns_plain(cols, ix)),
             f"the timed {label} gather")
        nbytes = gather_bytes(cols, ix)
        m = ix.shape[0]
        line = {"kernel": "gather_strings", "shape": label, "rows": m,
                "columns": len(cols), **measure(
                    lambda: S.gather_columns(cols, ix),
                    lambda: S.gather_columns_plain(cols, ix), None, nbytes)}
        emit(line)
        if label == "q3_join2_build":
            summary["gather_strings"] = summarize(line, nbytes)


def check_string_concat(rng, dev, q3, summary) -> None:
    big = with_edges(string_column(rng, RAGGED, dev), dev)
    cuts = sorted(rng.randint(0, big.num_rows, 6))
    slices = [big.slice_rows(a, b) for a, b in
              zip([0] + cuts, cuts + [big.num_rows])]
    cases = [("slices_of_one", slices),
             ("with_empty", [big.slice_rows(5, 5), slices[1],
                             DeviceColumn.from_strings([], dev), slices[2]]),
             ("one_piece", [big]),
             ("all_empty", [big.slice_rows(3, 3)] * 4),
             ("ragged", [string_column(rng, int(k), dev)
                         for k in rng.randint(0, 20_000, 58)])]
    for label, pieces in cases:
        got = S.concat_column(pieces)
        hold("concat_strings", string_pairs(got, S.concat_column_plain(pieces)),
             label)
    pieces = q3["reduce_pieces"]
    hold("concat_strings", string_pairs(S.concat_column(pieces),
                                        S.concat_column_plain(pieces)),
         "the timed q3 reduce-side pieces")
    rows = sum(p.num_rows for p in pieces)
    nb = sum(int(p.offsets[-1] - p.offsets[0]) for p in pieces)
    nbytes = 2 * (5 * rows + nb)
    line = {"kernel": "concat_strings", "shape": "q3_reduce", "pieces":
            len(pieces), "rows": rows, "bytes": nb, **measure(
                lambda: S.concat_column(pieces),
                lambda: S.concat_column_plain(pieces), None, nbytes)}
    emit(line)
    summary["concat_strings"] = summarize(line, nbytes)


def check_hash_string(rng, dev, q3, summary) -> None:
    abc = DeviceColumn.from_strings(["ABC", ""], dev)
    require(HK.murmur3_hash([abc]).tolist() == [-757602832, 142593372],
            "murmur3 of 'ABC' and '' differ from Spark's")
    for n in (N, RAGGED):
        sc = with_edges(string_column(rng, n, dev), dev)
        hold_murmur3([sc], f"n={sc.num_rows} strings", "hash_string")
        hold_murmur3([key_column(rng, sc.num_rows, T.INT, 1_000, dev), sc,
                      key_column(rng, sc.num_rows, T.DOUBLE, 1_000, dev)],
                     f"n={sc.num_rows} int, string, double chained",
                     "hash_string")
    keys = q3["partial_keys"]
    hold_murmur3(keys, "the timed q3 partial keys", "hash_string")
    n = keys[0].num_rows
    nb = int(keys[2].offsets[-1] - keys[2].offsets[0])
    nbytes, ops = 5 * n * 2 + 9 * n + nb + 8 * n, 28 * n * 2 + 8 * nb
    line = {"kernel": "hash_string", "shape": "q3_partial", "n": n,
            "columns": 3, **measure(
                lambda: HK.murmur3_partition(keys, SHUFFLE_PARTITIONS),
                lambda: HK.pmod(HK.murmur3_hash_plain(keys),
                                SHUFFLE_PARTITIONS), None, nbytes, ops)}
    emit(line)
    summary["hash_string"] = summarize(line, nbytes, ops)


def hold_string_sort_keys(col, what: str) -> None:
    o = col.offsets.to(torch.int64)
    lengths = torch.where(col.validity, o[1:] - o[:-1], 0)
    longest = int(lengths.max()) if col.num_rows else 0
    hold("string_sort_keys", zip(SK.string_sort_keys(col, longest),
                                 SK.string_sort_keys_plain(col, longest)),
         what)


def check_string_sort(rng, dev, q3, summary) -> None:
    for n in (N, RAGGED):
        sc = with_edges(string_column(rng, n, dev), dev)
        hold_string_sort_keys(sc, f"n={sc.num_rows}")
        for o in (SK.SortOrder(True), SK.SortOrder(False),
                  SK.SortOrder(True, False), SK.SortOrder(False, True)):
            hold_sort([sc], [o], f"n={sc.num_rows} strings {o}")
        hold_sort([key_column(rng, sc.num_rows, T.INT, 7, dev), sc],
                  [SK.SortOrder(), SK.SortOrder(False)],
                  f"n={sc.num_rows} int then string")
    # "ab" < "ab\0" < "ab\0\0" < "abc": binaryCompare, checked against the
    # bytes, not only against the plain version
    edge = DeviceColumn.from_strings(["ab\x00", "abc", "ab", "ab\x00\x00"], dev)
    got = SK.sort_indices(ColumnarBatch((edge,), 4, Schema(("s",), (T.STRING,))),
                          [0], [SK.SortOrder()])
    require(got.tolist() == [2, 0, 3, 1], f"string order {got.tolist()}")
    keys = q3["partial_keys"]
    orders = [SK.SortOrder()] * 3
    hold_sort(keys, orders, "the timed q3 partial keys")
    brand = keys[2]
    hold_string_sort_keys(brand, "the timed q3 brand column")
    n = brand.num_rows
    o = brand.offsets.to(torch.int64)
    longest = int((o[1:] - o[:-1]).max())
    nb = int(o[-1] - o[0])
    nchunks = SK.string_chunks(longest)
    nbytes = 4 * n + n + nb + (8 * nchunks + 4) * n
    line = {"kernel": "string_sort_keys", "shape": "q3_partial_brand",
            "n": n, "chunks": nchunks, **measure(
                lambda: SK.string_sort_keys(brand, longest),
                lambda: SK.string_sort_keys_plain(brand, longest), None,
                nbytes)}
    emit(line)
    summary["string_sort_keys"] = summarize(line, nbytes)
    batch = ColumnarBatch(tuple(keys), n, Schema(("y", "b", "s"),
                                                 (T.INT, T.INT, T.STRING)))
    big = string_column(rng, N, dev, lo=0, hi=64)
    big_batch = ColumnarBatch((big,), N, Schema(("s",), (T.STRING,)))
    for label, b, cols, ords in (
            ("q3_partial_3keys", batch, keys, orders),
            ("n_strings_0-64", big_batch, [big], [SK.SortOrder()])):
        hold_sort(cols, ords, f"the timed {label} sort")
        emit({"kernel": "sort", "shape": label, "n": b.num_rows, **measure(
            lambda: SK.sort_indices(b, list(range(len(cols))), ords),
            lambda: SK.sort_indices_plain(cols, ords), None,
            sum(c.data.numel() + c.validity.numel() for c in cols)
            + 4 * b.num_rows)})


def check_string_rows_equal(rng, dev, q3, summary) -> None:
    for n in (N, RAGGED):
        pool = with_edges(string_column(rng, 1_000, dev, null_frac=0.0), dev)
        draw = torch.from_numpy(rng.randint(-50, pool.num_rows, n).astype(
            np.int32)).to(dev)   # -50..-1: null rows
        col = S.gather_columns_plain([pool], draw)[0]
        sb = ColumnarBatch((col,), n, Schema(("s",), (T.STRING,)))
        srt = S.gather_columns_plain([col], SK.sort_indices(
            sb, [0], [SK.SortOrder()]))[0]
        for label, c in (("sorted", srt), ("unsorted", col)):
            hold("string_rows_equal_prev",
                 [(G.string_rows_equal_prev(c),
                   G.string_rows_equal_prev_plain(c))], f"n={n} {label}")
    # grouping end to end: the same groups as the plain path
    keys = q3["partial_keys"]
    work = ColumnarBatch(tuple(keys), keys[0].num_rows,
                         Schema(("y", "b", "s"), (T.INT, T.INT, T.STRING)))
    lay = G.group_rows(work, [0, 1, 2])
    hold("string_rows_equal_prev", [(lay.starts, G.group_rows(
        to_device(work, "cpu"), [0, 1, 2]).starts.to(dev))],
         "q3's group starts against the CPU")
    col = q3["sorted_brand"]
    hold("string_rows_equal_prev", [(G.string_rows_equal_prev(col),
                                     G.string_rows_equal_prev_plain(col))],
         "the timed q3 sorted brand")
    n = col.num_rows
    nb = int(col.offsets[-1] - col.offsets[0])
    nbytes = 5 * n + nb + (n - 1)
    line = {"kernel": "string_rows_equal_prev", "shape": "q3_sorted_brand",
            "n": n, **measure(lambda: G.string_rows_equal_prev(col),
                              lambda: G.string_rows_equal_prev_plain(col),
                              None, nbytes)}
    emit(line)
    summary["string_rows_equal_prev"] = summarize(line, nbytes)


def build_batch(col: DeviceColumn) -> ColumnarBatch:
    return ColumnarBatch((col,), col.num_rows, Schema(("k",), (col.dtype,)))


def hold_expand(lo, off, total: int, build, n: int, join_type: str,
                what: str) -> None:
    """The expand against the plain one; a left join's maps hold every
    one of the n stream rows."""
    li, ri = JK.join_expand(lo, off, total, build)
    hold("join_expand", zip((li, ri), JK.expand_plain(lo, off, total,
                                                      build.perm)), what)
    if join_type == "left":
        require(int(torch.unique(li).shape[0]) == n,
                f"a left join lost a stream row: {what}")


def hold_join(stream: DeviceColumn, build_col: DeviceColumn, what: str,
              join_type: str = "inner"):
    """The kernel path (build, probe, expand) against the plain one, step
    by step on the same tensors; returns the kernel's build."""
    left = join_type == "left"
    probe = "join_probe_left" if left else "join_probe"
    build = JK.build_side(build_batch(build_col), 0)
    norm = G.normalize_key_column(build_col)
    hold("join_build", zip(JK.build_keys(norm, build.perm),
                           JK.build_keys_plain(norm, build.perm)), what)
    lo, off, total = JK.join_probe(build_batch(stream), 0, build, join_type)
    plo, poff, ptotal = JK.probe_plain(stream, build, join_type)
    require(total == ptotal, f"{probe}: {total} pairs against {ptotal}: "
            f"{what}")
    hold(probe, [(lo, plo), (off, poff)], what)
    hold_expand(lo, off, total, build, stream.num_rows, join_type, what)
    return build, (lo, off, total)


def check_join(rng, dev, q3, summary) -> None:
    b1 = q3["build1"].columns[0]
    b2 = q3["build2"].columns[0]
    wide = key_column(rng, 100_000, T.INT, 60_000, dev)   # duplicates
    for n in (N, RAGGED):
        for label, build in (("186", b1), ("857", b2), ("100000", wide)):
            lo_v = int(build.data.min()) - 5
            hi_v = int(build.data.max()) + 5
            vals = rng.randint(lo_v, hi_v, n).astype(np.int32)
            stream = DeviceColumn.from_numpy(vals, T.INT, rng.rand(n) >= 0.1,
                                             dev)
            hold_join(stream, build, f"n={n} int32 against {label} keys")
        longs = key_column(rng, n, T.LONG, 1_000, dev)
        hold_join(longs, key_column(rng, 100_000, T.LONG, 1_000, dev),
                  f"n={n} int64 keys with duplicates")
        dbl = key_column(rng, n, T.DOUBLE, 1_000, dev)
        hold_join(dbl, key_column(rng, 100_000, T.DOUBLE, 1_000, dev),
                  f"n={n} double keys with -0.0 and NaN")
        hold_join(key_column(rng, n, T.INT, 1_000, dev),
                  key_column(rng, 5_000, T.LONG, 1_000, dev),
                  f"n={n} int32 stream, int64 build")
    hold_join(key_column(rng, N, T.INT, 1_000, dev),
              DeviceColumn.from_numpy(np.zeros(0, np.int32), T.INT, None, dev),
              "an empty build")
    # q3's shapes: the first join, then the second
    s1, s2 = q3["stream1"], q3["stream2"]
    build1, (lo, off, total) = hold_join(s1, b1, "the timed q3 first join")
    require(total == q3["pairs1"], f"q3 join 1: {total} pairs, numpy "
            f"{q3['pairs1']}")
    _, (_, _, total2) = hold_join(s2, b2, "q3's second join")
    require(total2 == q3["pairs2"], f"q3 join 2: {total2} pairs")
    n, nb = s1.num_rows, build1.num_rows
    sorted_keys = (build1.keys ^ JK._SIGN64)[:int(build1.key_valid.sum())]
    probe_keys = JK.order_keys_plain(s1) ^ JK._SIGN64
    steps = max(nb, 1).bit_length()
    nbytes, ops = 5 * n + 8 * n + 8 * n + 9 * nb, 2 * steps * 4 * n
    line = {"kernel": "join_probe", "shape": "q3_join1", "n": n,
            "build": nb, "pairs": total, **measure(
                lambda: JK.join_probe(build_batch(s1), 0, build1),
                lambda: JK.probe_plain(s1, build1),
                lambda: (torch.searchsorted(sorted_keys, probe_keys),
                         torch.searchsorted(sorted_keys, probe_keys,
                                            right=True)),
                nbytes, ops)}
    emit(line)
    summary["join_probe"] = summarize(line, nbytes, ops)
    nbytes = 8 * total + 8 * n + 4 * nb
    line = {"kernel": "join_expand", "shape": "q3_join1", "n": n,
            "pairs": total, **measure(
                lambda: JK.join_expand(lo, off, total, build1),
                lambda: JK.expand_plain(lo, off, total, build1.perm), None,
                nbytes)}
    emit(line)
    summary["join_expand"] = summarize(line, nbytes)
    norm = G.normalize_key_column(b2)
    perm = JK.build_side(q3["build2"], 0).perm
    nbytes = (4 + 1 + 4) * b2.num_rows + 9 * b2.num_rows
    line = {"kernel": "join_build", "shape": "q3_item_857", "n": b2.num_rows,
            **measure(lambda: JK.build_keys(norm, perm),
                      lambda: JK.build_keys_plain(norm, perm), None, nbytes)}
    emit(line)
    summary["join_build"] = summarize(line, nbytes)


# -- phase 3: the q25 path's several-key join ---------------------------------

def multi_column(rng, n, kind: str, distinct: int, dev, null_frac=0.1,
                 pool=None) -> DeviceColumn:
    """n keys of about ``distinct`` values with nulls: int32 and int64 over
    the same range (an int64 key also takes values outside int32's, 5%),
    doubles (-0.0, 0.0 and NaNs of both signs at 5%), or strings drawn
    from ``pool``."""
    valid = rng.rand(n) >= null_frac
    if kind == "string":
        pick = rng.randint(0, len(pool), n)
        return DeviceColumn.from_strings(
            [pool[i] if ok else None for i, ok in zip(pick, valid)], dev)
    v = rng.randint(0, distinct, n).astype(np.int64) - distinct // 2
    if kind == "double":
        vals = v / 4.0
        special = rng.rand(n) < 0.05
        vals[special] = rng.choice(SPECIAL_KEYS, int(special.sum()))
        return DeviceColumn.from_numpy(vals, T.DOUBLE, valid, dev)
    if kind == "long":
        wide = rng.rand(n) < 0.05
        v[wide] += 2**33
        return DeviceColumn.from_numpy(v, T.LONG, valid, dev)
    return DeviceColumn.from_numpy(v.astype(np.int32), T.INT, valid, dev)


def string_pool(rng, size: int, longest: int) -> list:
    """``size`` distinct strings of 0..longest bytes beside the edge
    cases, many sharing a prefix."""
    out = {s for s in STRING_EDGES if s is not None}
    while len(out) < size:
        k = int(rng.randint(0, longest + 1))
        out.add("pfx-"[:min(k, 4)] + "".join(
            chr(c) for c in rng.randint(0x20, 0x7f, max(k - 4, 0))))
    return sorted(out)


def keys_batch(cols) -> ColumnarBatch:
    return ColumnarBatch(tuple(cols), cols[0].num_rows, Schema(
        tuple(f"k{i}" for i in range(len(cols))),
        tuple(c.dtype for c in cols)))


def numpy_pairs(stream_cols, build_cols) -> int:
    """The pairs of a join on two int keys (both within int32), counted on
    the host over int64 packings of the keys: the independent check."""
    def packed(cols):
        (a, va), (b, vb) = (c.to_numpy() for c in cols)
        k = (a.astype(np.int64) << 32) | (b.astype(np.int64) & 0xFFFFFFFF)
        return k[va & vb]
    sk, bk = packed(stream_cols), np.sort(packed(build_cols))
    return int((np.searchsorted(bk, sk, "right")
                - np.searchsorted(bk, sk, "left")).sum())


def hold_multi_join(stream_cols, build_cols, what: str,
                    join_type: str = "inner"):
    """The several-key kernel path (build words, probe, expand) against the
    plain one, step by step on the same tensors; returns the build and the
    probe's (lo, offsets, pairs)."""
    keys = list(range(len(build_cols)))
    build = JK.build_side(keys_batch(build_cols), keys)
    require(build.multi, f"{what}: the build is not the several-key one")
    norm = [G.normalize_key_column(c) for c in build_cols]
    chunks = tuple(SK.string_chunks(SK._longest_plain(c)) if c.is_string
                   else None for c in norm)
    require(build.chunks == chunks, f"join_multi_build: chunks "
            f"{build.chunks} against {chunks}: {what}")
    hold("join_multi_build", zip((build.keys, build.key_valid),
                                 JK.key_words_plain(norm, chunks,
                                                    build.perm)), what)
    # the words the sort ordered are in order, the rows with a null last
    nv = int(build.key_valid.sum())
    require(bool(build.key_valid[:nv].all()) and
            not bool(build.key_valid[nv:].any()), f"null tail: {what}")
    if nv > 1:
        _, rank = torch.unique(build.keys[:nv] ^ JK._SIGN64, dim=0,
                               return_inverse=True)
        require(bool((rank[1:] >= rank[:-1]).all()),
                f"join_multi_build: words out of order: {what}")
    left = join_type == "left"
    probe = "join_multi_probe_left" if left else "join_multi_probe"
    lo, off, total = JK.join_probe(keys_batch(stream_cols), keys, build,
                                   join_type)
    plo, poff, ptotal = JK.probe_multi_plain(
        *JK.key_words_plain(stream_cols, build.chunks), build,
        join_type)
    require(total == ptotal, f"{probe}: {total} pairs against {ptotal}: "
            f"{what}")
    hold(probe, [(lo, plo), (off, poff)], what)
    hold_expand(lo, off, total, build, stream_cols[0].num_rows, join_type,
                what)
    return build, (lo, off, total)


MULTI_CASES = (("int32_int32", ("int", "int"), ("int", "int")),
               ("int32_int64", ("int", "long"), ("long", "int")),
               ("double_double", ("double", "double"), ("double", "double")),
               ("int_string", ("int", "string"), ("int", "string")))


def q25_join_shapes(rng, dev) -> dict:
    """q25's two shuffled joins as one partition sees them at SF10, with
    keys drawn as the generators draw them: store_sales (ticket, item)
    1,048,576 stream rows against 180,000 store_returns rows, 90% of them
    copied from a sale; then 162,000 (customer, item) pairs against
    900,000 catalog_sales rows, 70% copied from a pool of 180,000 pairs
    that holds the stream's."""
    def col(v):
        return DeviceColumn.from_numpy(v.astype(np.int32), T.INT, None, dev)
    n1, nb1 = N, 180_000
    ticket = 1 + rng.randint(0, SS_ROWS // 4, n1)
    item = 1 + rng.randint(0, ITEM_ROWS, n1)
    take = rng.rand(nb1) < 0.9
    src = rng.randint(0, n1, nb1)
    bt = np.where(take, ticket[src], 1 + rng.randint(0, 500_000, nb1))
    bi = np.where(take, item[src], 1 + rng.randint(0, ITEM_ROWS, nb1))
    n2, nb2, npool = 162_000, 900_000, 180_000
    cust = 1 + rng.randint(0, 50_000, npool)
    pitem = 1 + rng.randint(0, ITEM_ROWS, npool)
    take = rng.rand(nb2) < 0.7
    src = rng.randint(0, npool, nb2)
    bc = np.where(take, cust[src], 1 + rng.randint(0, 50_000, nb2))
    bi2 = np.where(take, pitem[src], 1 + rng.randint(0, ITEM_ROWS, nb2))
    return {"ss_sr": ([col(ticket), col(item)], [col(bt), col(bi)]),
            "cs": ([col(cust[:n2]), col(pitem[:n2])], [col(bc), col(bi2)])}


def check_string_chunks_reuploaded(rng, dev, pool) -> None:
    """The string sort keys of one column of short strings and up to 20
    bytes (3 chunks), uploaded anew into reused memory four times: a
    chunk loop that selected on a loaded byte once wrote a wrong top byte
    into the last chunk of some rows here, which depended on what the
    memory held before."""
    strs = [pool[i] for i in rng.randint(0, 30, 5_000)]
    for trial in range(4):
        col = DeviceColumn.from_strings(strs, dev)
        hold_string_sort_keys(col, f"reuploaded short strings, trial {trial}")
        hold_sort([col], [SK.SortOrder()],
                  f"reuploaded strings, trial {trial}")


def check_multi_join(rng, dev, summary) -> None:
    pool = string_pool(rng, 300, 20)
    check_string_chunks_reuploaded(rng, dev, pool)
    long_pool = pool + ["pfx-" + "z" * k for k in (21, 40, 64)] + [
        p + "\x00" * 9 for p in pool[:20]]   # longer than any build string
    for n in (N, RAGGED):
        for nb in (186, 180_000, 900_000):
            d = int(np.sqrt(nb / 2)) + 2    # about two build rows a tuple
            for label, skinds, bkinds in MULTI_CASES:
                spool = long_pool if "string" in skinds else None
                stream = [multi_column(rng, n, k, d, dev, pool=spool)
                          for k in skinds]
                build = [multi_column(rng, nb, k, d, dev,
                                      pool=pool[:max(d, 8)])
                         for k in bkinds]
                what = f"n={n} {label} against {nb} build rows"
                _, (_, _, total) = hold_multi_join(stream, build, what)
                if label == "int32_int32":
                    want = numpy_pairs(stream, build)
                    require(total == want, f"{what}: {total} pairs, numpy "
                            f"{want}")
    shapes = q25_join_shapes(rng, dev)
    for label, (scols, bcols) in shapes.items():
        build, (lo, off, total) = hold_multi_join(scols, bcols,
                                                  f"the timed q25 {label}")
        want = numpy_pairs(scols, bcols)
        require(total == want, f"q25 {label}: {total} pairs, numpy {want}")
        n, nb, nw = scols[0].num_rows, build.num_rows, build.keys.shape[1]
        sb = keys_batch(scols)
        # the library call: two searches over one int64 key packing the
        # two int32 keys (non-negative here, so the packing keeps order)
        (sa, _), (sb_, _) = (c.to_numpy() for c in scols)
        (ba, _), (bb, _) = (c.to_numpy() for c in bcols)
        lib_probe = torch.from_numpy(
            (sa.astype(np.int64) << 32) | sb_.astype(np.int64)).to(dev)
        lib_build = torch.from_numpy(np.sort(
            (ba.astype(np.int64) << 32) | bb.astype(np.int64))).to(dev)
        steps = max(nb, 1).bit_length()
        # the words of each stream row, (lo, count) written and scanned, the
        # build's words read once; 2 binary searches of nw-word compares
        nbytes = 8 * nw * n + 16 * n + (8 * nw + 1) * nb
        ops = 2 * steps * 2 * nw * n
        line = {"kernel": "join_multi_probe", "shape": f"q25_{label}",
                "n": n, "build": nb, "words": nw, "pairs": total, **measure(
                    lambda: JK.join_probe(sb, [0, 1], build),
                    lambda: JK.probe_multi_plain(
                        *JK.key_words_plain(scols, build.chunks), build),
                    lambda: (torch.searchsorted(lib_build, lib_probe),
                             torch.searchsorted(lib_build, lib_probe,
                                                right=True)),
                    nbytes, ops)}
        emit(line)
        if label == "ss_sr":
            summary["join_multi_probe"] = summarize(line, nbytes, ops)
        norm = [G.normalize_key_column(c) for c in bcols]
        perm = build.perm
        nbytes = (4 + 5 * len(norm)) * nb + (8 * nw + 1) * nb
        line = {"kernel": "join_multi_build", "shape": f"q25_{label}",
                "n": nb, "words": nw, **measure(
                    lambda: JK.build_words(norm, perm),
                    lambda: JK.key_words_plain(norm, build.chunks, perm),
                    None, nbytes)}
        emit(line)
        if label == "cs":
            summary["join_multi_build"] = summarize(line, nbytes)
        nbytes = 8 * total + 8 * n + 4 * total
        emit({"kernel": "join_expand", "shape": f"q25_{label}", "n": n,
              "pairs": total, **measure(
                  lambda: JK.join_expand(lo, off, total, build),
                  lambda: JK.expand_plain(lo, off, total, build.perm), None,
                  nbytes)})


# -- phase 3: the q72 path's conditional and left joins -----------------------

COND_TYPES = ("inner", "left", "right", "full", "left_semi", "left_anti",
              "existence")
# q72 at SF10 in 200 shuffle partitions: a partition's catalog_sales and
# inventory rows, and the rows a partition's left joins see after the
# week and ship-date filters (~28,000 over 200 partitions)
Q72_STREAM, Q72_BUILD, Q72_LEFT_ROWS = 72_000, 665_550, 140


def candidates(rng, n: int, nl: int, nr: int, rate: float, dev):
    """n candidate pairs as an inner expansion gives them (left rows in
    order, each with a Poisson count of right rows, so that some have
    none), live masks with 3% dead rows, and a pass mask of ``rate`` over
    the pairs of live rows."""
    li = np.sort(rng.randint(0, nl, n)).astype(np.int32)
    ri = rng.randint(0, nr, n).astype(np.int32)
    llive, rlive = rng.rand(nl) >= 0.03, rng.rand(nr) >= 0.03
    passed = (rng.rand(n) < rate) & llive[li] & rlive[ri]
    return [torch.from_numpy(a).to(dev) for a in (li, ri, passed, llive,
                                                  rlive)]


def hold_cond(args, join_type: str, what: str):
    got = JK.conditional_join_maps(*args, join_type)
    want = JK.conditional_join_maps_plain(*args, join_type)
    hold("conditional_join_maps", zip(got, want), f"{join_type} {what}")
    return got


def q72_candidates(dev):
    """One partition of q72's inventory join at SF10: 72,000 sales against
    665,550 inventory rows, each sale with ~1,305 candidates (the
    snapshots of its item), 10% of them passing (on hand 0-499 below a
    quantity of 1-99)."""
    g = torch.Generator(device=dev).manual_seed(72)
    counts = torch.randint(1_200, 1_411, (Q72_STREAM,), generator=g,
                           device=dev)
    li = torch.repeat_interleave(
        torch.arange(Q72_STREAM, dtype=torch.int32, device=dev), counts)
    n = li.shape[0]
    ri = torch.randint(0, Q72_BUILD, (n,), generator=g, device=dev,
                       dtype=torch.int32)
    qty = torch.randint(1, 100, (Q72_STREAM,), generator=g, device=dev)
    on_hand = torch.randint(0, 500, (Q72_BUILD,), generator=g, device=dev)
    passed = on_hand[ri.long()] < qty[li.long()]
    ones = torch.ones(Q72_STREAM, dtype=torch.bool, device=dev)
    return [li, ri, passed, ones,
            torch.ones(Q72_BUILD, dtype=torch.bool, device=dev)]


def check_conditional_join(rng, dev, summary) -> None:
    for n in (N, RAGGED):
        for rate in (0.0, 0.1, 1.0):
            args = candidates(rng, n, n // 3, 50_000, rate, dev)
            for jt in COND_TYPES:
                li2, ri2, _ = hold_cond(args, jt, f"n={n} rate={rate}")
                if jt == "inner":
                    require(li2.shape[0] == int(args[2].sum()),
                            f"conditional inner: {li2.shape[0]} rows")
    args = q72_candidates(dev)
    li2, ri2, _ = hold_cond(args, "inner", "q72's inventory join")
    n, count = args[0].shape[0], li2.shape[0]
    li, ri, passed = args[:3]

    def library():
        idx = torch.nonzero(passed).squeeze(1)
        return li.index_select(0, idx), ri.index_select(0, idx)
    # the candidates and the mask read, the flags written, the maps written
    nbytes = 9 * n + 2 * (Q72_STREAM + Q72_BUILD) + 8 * count
    line = {"kernel": "conditional_join_maps", "shape": "q72_inventory",
            "candidates": n, "passed": count, **measure(
                lambda: JK.conditional_join_maps(*args, "inner"),
                lambda: JK.conditional_join_maps_plain(*args, "inner"),
                library, nbytes)}
    emit(line)
    summary["conditional_join_maps"] = summarize(line, nbytes)
    del args, li, ri, passed, li2, ri2


def check_left_join(rng, dev, summary) -> None:
    promo = DeviceColumn.from_numpy(np.arange(1, 301, dtype=np.int32), T.INT,
                                    None, dev)
    empty = DeviceColumn.from_numpy(np.zeros(0, np.int32), T.INT, None, dev)
    for n in (N, RAGGED):
        keys = DeviceColumn.from_numpy(
            rng.randint(1, 400, n).astype(np.int32), T.INT,
            rng.rand(n) >= 0.15, dev)
        hold_join(keys, promo, f"n={n} against promotion's 300 keys, "
                  "15% null", "left")
        hold_join(keys, key_column(rng, 50_000, T.INT, 600, dev),
                  f"n={n} against 50,000 keys with duplicates", "left")
        hold_join(key_column(rng, n, T.DOUBLE, 1_000, dev),
                  key_column(rng, 5_000, T.DOUBLE, 1_000, dev),
                  f"n={n} double keys with -0.0 and NaN", "left")
        hold_join(keys, empty, f"n={n} against an empty build", "left")
    stream = DeviceColumn.from_numpy(
        rng.randint(1, 301, Q72_LEFT_ROWS).astype(np.int32), T.INT,
        rng.rand(Q72_LEFT_ROWS) >= 0.15, dev)
    build, (lo, off, total) = hold_join(stream, promo,
                                        "q72's promotion join", "left")
    sorted_keys = (build.keys ^ JK._SIGN64)[:int(build.key_valid.sum())]
    probe_keys = JK.order_keys_plain(stream) ^ JK._SIGN64
    n, nb = Q72_LEFT_ROWS, promo.num_rows
    steps = nb.bit_length()
    nbytes, ops = 5 * n + 16 * n + 9 * nb, 2 * steps * 4 * n
    line = {"kernel": "join_probe_left", "shape": "q72_promotion", "n": n,
            "build": nb, "pairs": total, **measure(
                lambda: JK.join_probe(build_batch(stream), 0, build, "left"),
                lambda: JK.probe_plain(stream, build, "left"),
                lambda: (torch.searchsorted(sorted_keys, probe_keys),
                         torch.searchsorted(sorted_keys, probe_keys,
                                            right=True)),
                nbytes, ops)}
    emit(line)
    summary["join_probe_left"] = summarize(line, nbytes, ops)


def returns_like(rng, item, order, n: int, dev, null_frac=0.0):
    """n catalog_returns keys, 60% copied from the given sales' (item,
    order) pairs, as the generator draws them."""
    take = rng.rand(n) < 0.6
    src = rng.randint(0, len(item), n)
    ri = np.where(take, item[src], 1 + rng.randint(0, ITEM_ROWS, n))
    ro = np.where(take, order[src], 1 + rng.randint(0, 100_000, n))
    valid = rng.rand(n) >= null_frac
    return [DeviceColumn.from_numpy(v.astype(np.int32), T.INT, valid, dev)
            for v in (ri, ro)]


def check_left_multi_join(rng, dev, summary) -> None:
    pool = string_pool(rng, 300, 20)
    for n in (N, RAGGED):
        item = 1 + rng.randint(0, ITEM_ROWS, n)
        order = 1 + rng.randint(0, CS_ROWS // 3, n)
        valid = rng.rand(n) >= 0.1
        stream = [DeviceColumn.from_numpy(v.astype(np.int32), T.INT, valid,
                                          dev) for v in (item, order)]
        for nb in (7_200, 180_000):
            hold_multi_join(stream, returns_like(rng, item, order, nb,
                                                 dev, 0.05),
                            f"n={n} (int32, int32) against {nb} rows",
                            "left")
        d = 300
        sstr = [multi_column(rng, n, k, d, dev, pool=pool)
                for k in ("int", "string")]
        bstr = [multi_column(rng, 20_000, k, d, dev, pool=pool[:100])
                for k in ("int", "string")]
        hold_multi_join(sstr, bstr, f"n={n} (int, string) with nulls",
                        "left")
        for cols, label in ((stream, "(int32, int32)"),
                            (sstr, "(int, string)")):
            empty = [DeviceColumn.from_numpy(np.zeros(0, np.int32), T.INT,
                                             None, dev)
                     if not c.is_string else DeviceColumn.from_strings([], dev)
                     for c in cols]
            build, (lo, off, total) = hold_multi_join(
                cols, empty, f"n={n} {label} against an empty build", "left")
            require(total == n, f"an empty build gave {total} rows, not {n}")
    # q72's shape: a partition's ~140 filtered sales against its ~7,200
    # catalog_returns rows
    item = 1 + rng.randint(0, ITEM_ROWS, Q72_LEFT_ROWS)
    order = 1 + rng.randint(0, CS_ROWS // 3, Q72_LEFT_ROWS)
    scols = [DeviceColumn.from_numpy(v.astype(np.int32), T.INT, None, dev)
             for v in (item, order)]
    bcols = returns_like(rng, item, order, 7_200, dev)
    build, (lo, off, total) = hold_multi_join(scols, bcols,
                                              "q72's returns join", "left")
    sb = keys_batch(scols)
    n, nb, nw = Q72_LEFT_ROWS, build.num_rows, build.keys.shape[1]
    (sa, _), (sb_, _) = (c.to_numpy() for c in scols)
    (ba, _), (bb, _) = (c.to_numpy() for c in bcols)
    lib_probe = torch.from_numpy(
        (sa.astype(np.int64) << 32) | sb_.astype(np.int64)).to(dev)
    lib_build = torch.from_numpy(np.sort(
        (ba.astype(np.int64) << 32) | bb.astype(np.int64))).to(dev)
    steps = max(nb, 1).bit_length()
    nbytes = 8 * nw * n + 16 * n + (8 * nw + 1) * nb
    ops = 2 * steps * 2 * nw * n
    line = {"kernel": "join_multi_probe_left", "shape": "q72_returns",
            "n": n, "build": nb, "words": nw, "pairs": total, **measure(
                lambda: JK.join_probe(sb, [0, 1], build, "left"),
                lambda: JK.probe_multi_plain(
                    *JK.key_words_plain(scols, build.chunks), build,
                    "left"),
                lambda: (torch.searchsorted(lib_build, lib_probe),
                         torch.searchsorted(lib_build, lib_probe,
                                            right=True)),
                nbytes, ops)}
    emit(line)
    summary["join_multi_probe_left"] = summarize(line, nbytes, ops)


def hold_null_extend(cols, ix: torch.Tensor, what: str) -> None:
    got = S.gather_columns(cols, ix, null_extend=True)
    want = S.gather_columns_plain(cols, ix)
    pairs = []
    for g, w in zip(got, want, strict=True):
        pairs += (string_pairs(g, w) if g.is_string
                  else [(g.data, w.data), (g.validity, w.validity)])
    hold("gather_null_extend", pairs, what)
    missing = (ix < 0) | (ix >= cols[0].num_rows)
    for g in got:
        require(not bool(g.validity[missing].any()),
                f"gather_null_extend: a -1 row is not null: {what}")


def check_null_extend(rng, dev, summary) -> None:
    for n in (N, RAGGED):
        strings = with_edges(string_column(rng, 200_000, dev, lo=0, hi=40),
                             dev)
        m = strings.num_rows
        src = [random_column(rng, m, T.INT, 0.1, dev),
               random_column(rng, m, T.DOUBLE, 0.1, dev), strings]
        ix = rng.randint(0, m, n).astype(np.int32)
        ix[rng.rand(n) < 0.3] = -1
        ix = torch.from_numpy(ix).to(dev)
        hold_null_extend(src, ix, f"n={n}, 30% -1 indices")
        empty = [S.gather_columns_plain([c], ix[:0])[0] for c in src]
        hold_null_extend(empty, torch.full((n,), -1, dtype=torch.int32,
                                           device=dev),
                         f"n={n} from an empty source")
    # q72's shape: the returns join's right columns (the two keys) for a
    # partition's ~140 rows, about 60% without a return
    cols = [random_column(rng, 7_200, T.INT, 0.0, dev) for _ in range(2)]
    ix = rng.randint(0, 7_200, Q72_LEFT_ROWS).astype(np.int32)
    ix[rng.rand(Q72_LEFT_ROWS) < 0.6] = -1
    ix = torch.from_numpy(ix).to(dev)
    hold_null_extend(cols, ix, "q72's returns join")
    nbytes = gather_bytes(cols, ix.clamp(min=0))

    def library():
        safe = ix.clamp(min=0).long()
        return [c.data.index_select(0, safe) for c in cols]
    line = {"kernel": "gather_null_extend", "shape": "q72_returns",
            "n": Q72_LEFT_ROWS, **measure(
                lambda: S.gather_columns(cols, ix, null_extend=True),
                lambda: S.gather_columns_plain(cols, ix), library, nbytes)}
    emit(line)
    summary["gather_null_extend"] = summarize(line, nbytes)


# -- phase 3: the q14a path's semi and anti joins -----------------------------

SEMI_TYPES = ("left_semi", "left_anti")
MAXL = 2**63 - 1
# q14a at SF10 in 200 shuffle partitions: one partition of the first
# cross-channel semi join, the store channel's (brand, manufacturer,
# category) triples against the catalog channel's
Q14A_STREAM, Q14A_BUILD = SS_ROWS // 200, CS_ROWS // 200


def pack3(a, b, c) -> np.ndarray:
    """Three non-negative keys below 2**21 as one order-keeping int64."""
    return (a.astype(np.int64) << 42) | (b.astype(np.int64) << 21) | \
        c.astype(np.int64)


def probe_name(multi: bool, join_type: str) -> str:
    return (("join_multi_probe" if multi else "join_probe")
            + ("_semi" if join_type == "left_semi" else "_anti"))


def hold_left_only(cols, build, join_type: str, what: str):
    """The semi or anti probe and the left-only expand against their plain
    twins on the same tensors: offsets and counts, the kept rows, the
    empty right map, no first match; returns (offsets, rows kept, li)."""
    name = probe_name(build.multi, join_type)
    keys = list(range(len(cols)))
    lo, off, total = JK.join_probe(keys_batch(cols), keys, build, join_type)
    if build.multi:
        plo, poff, ptotal = JK.probe_multi_plain(
            *JK.key_words_plain(cols, build.chunks), build, join_type)
    else:
        plo, poff, ptotal = JK.probe_plain(cols[0], build, join_type)
    require(total == ptotal, f"{name}: {total} rows against {ptotal}: "
            f"{what}")
    require(lo.numel() == 0 and plo.numel() == 0,
            f"{name} wrote a first match: {what}")
    hold(name, [(off, poff)], what)
    li, ri = JK.join_expand(lo, off, total, build, join_type)
    hold("join_expand_left_only",
         zip((li, ri), JK.expand_left_only_plain(poff, ptotal)), what)
    return off, total, li


def numpy_kept(stream_cols, build_cols, join_type: str) -> np.ndarray:
    """The rows a semi or anti join keeps, on the host: np.isin over the
    valid rows' keys, one int key as it is, several packed into int64
    (keys of either sign below 2**20): the independent check."""
    def packed(cols):
        arrays = [c.to_numpy() for c in cols]
        valid = np.logical_and.reduce([v for _, v in arrays])
        if len(cols) == 1:
            return arrays[0][0].astype(np.int64), valid
        vals = [a.astype(np.int64) + 2**20 for a, _ in arrays]
        for a in vals:
            require(bool(((a >= 0) & (a < 2**21)).all()), "keys past 2**20")
        while len(vals) < 3:
            vals.insert(0, np.zeros_like(vals[0]))
        return pack3(*vals), valid
    sk, sv = packed(stream_cols)
    bk, bv = packed(build_cols)
    hit = sv & np.isin(sk, bk[bv])
    return np.flatnonzero(hit if join_type == "left_semi" else ~hit)


def hold_semi_case(stream_cols, build_cols, what: str,
                   independent: bool = False) -> None:
    """Both join types on one build, with the numpy check where asked."""
    keys = list(range(len(build_cols)))
    build = JK.build_side(keys_batch(build_cols), keys)
    for join_type in SEMI_TYPES:
        _, total, li = hold_left_only(stream_cols, build, join_type,
                                      f"{join_type} {what}")
        if independent:
            want = numpy_kept(stream_cols, build_cols, join_type)
            require(total == len(want) and np.array_equal(
                li.cpu().numpy(), want), f"{join_type} {what}: {total} "
                f"rows kept, numpy {len(want)}")


def with_long_extremes(rng, col: DeviceColumn, dev) -> DeviceColumn:
    """An int64 key column with Long.MAX_VALUE and Long.MIN_VALUE at 1%
    of its rows each."""
    vals, valid = col.to_numpy()
    pick = rng.rand(len(vals))
    vals[pick < 0.01] = MAXL
    vals[(pick >= 0.01) & (pick < 0.02)] = -MAXL - 1
    return DeviceColumn.from_numpy(vals, T.LONG, valid, dev)


def item_triples(tables, item_sk: np.ndarray) -> list:
    """The (brand, manufacturer, category) of each item, as q14a's branded
    join gives them."""
    i = tables[3]
    return [i[k][item_sk - 1] for k in ("i_brand_id", "i_manufact_id",
                                        "i_category_id")]


def int_cols(arrays, dev, null_frac: float = 0.0, rng=None) -> list:
    """int32 key columns, each with its own ``null_frac`` of nulls."""
    return [DeviceColumn.from_numpy(
        a.astype(np.int32), T.INT,
        None if not null_frac else rng.rand(len(a)) >= null_frac, dev)
        for a in arrays]


def check_semi_join(rng, dev, tables, summary) -> None:
    empty_int = DeviceColumn.from_numpy(np.zeros(0, np.int32), T.INT, None,
                                        dev)
    pool = string_pool(rng, 300, 20)
    for n in (N, RAGGED):
        ints = key_column(rng, n, T.INT, 1_000, dev)
        for nb, d in ((186, 1_000), (100_000, 60_000)):
            hold_semi_case([ints], [key_column(rng, nb, T.INT, d, dev)],
                           f"n={n} int32 against {nb} keys", True)
        longs = with_long_extremes(rng, key_column(rng, n, T.LONG, 1_000,
                                                   dev), dev)
        hold_semi_case([longs], [with_long_extremes(rng, key_column(
            rng, 50_000, T.LONG, 1_000, dev), dev)],
            f"n={n} int64 with Long.MAX_VALUE and MIN_VALUE")
        hold_semi_case([key_column(rng, n, T.DOUBLE, 1_000, dev)],
                       [key_column(rng, 50_000, T.DOUBLE, 1_000, dev)],
                       f"n={n} double keys with -0.0 and NaN")
        hold_semi_case([ints], [empty_int], f"n={n} against an empty build",
                       True)
        hold_semi_case([key_column(rng, n, T.INT, 1_000, dev,
                                   null_frac=1.0)],
                       [key_column(rng, 5_000, T.INT, 1_000, dev)],
                       f"n={n} all-null stream keys", True)
        # several keys: q14a's item triples, 5% nulls a key; (int, string)
        triples = int_cols(item_triples(tables, 1 + rng.randint(
            0, ITEM_ROWS, n)), dev, 0.05, rng)
        for nb in (Q14A_BUILD, 186):
            hold_semi_case(triples, int_cols(item_triples(
                tables, 1 + rng.randint(0, ITEM_ROWS, nb)), dev, 0.05, rng),
                f"n={n} item triples against {nb}", True)
        sstr = [multi_column(rng, n, "int", 30, dev, pool=pool),
                multi_column(rng, n, "string", 30, dev, pool=pool)]
        bstr = [multi_column(rng, 20_000, "int", 30, dev, pool=pool),
                multi_column(rng, 20_000, "string", 30, dev,
                             pool=pool[:100])]
        hold_semi_case(sstr, bstr, f"n={n} (int, string) with nulls")
        empty = [empty_int, DeviceColumn.from_strings([], dev)]
        hold_semi_case(sstr, empty, f"n={n} (int, string) against an "
                       "empty build")
        nulls = int_cols(item_triples(tables, 1 + rng.randint(
            0, ITEM_ROWS, n)), dev, 1.0, rng)
        hold_semi_case(nulls, triples[:], f"n={n} all-null triples", True)
    hold_semi_case([empty_int], [key_column(rng, 186, T.INT, 1_000, dev)],
                   "an empty stream")
    hold_semi_case([empty_int] * 3, int_cols(item_triples(
        tables, 1 + rng.randint(0, ITEM_ROWS, 500)), dev),
        "an empty stream of triples")
    time_semi_join(rng, dev, tables, summary)


def library_left_only(sorted_build: torch.Tensor, probe: torch.Tensor,
                      valid: torch.Tensor, join_type: str):
    """One-key semi or anti join from PyTorch calls: torch.searchsorted of
    the (packed) stream keys in the sorted valid build keys, the hit read
    back, torch.nonzero of the kept rows."""
    def run():
        if sorted_build.numel() == 0:
            hit = torch.zeros_like(valid)
        else:
            pos = torch.searchsorted(sorted_build, probe).clamp(
                max=sorted_build.numel() - 1)
            hit = (sorted_build[pos] == probe) & valid
        return torch.nonzero(hit if join_type == "left_semi" else ~hit)
    return run


def time_semi_join(rng, dev, tables, summary) -> None:
    """The timed shapes: q14a's first cross-channel semi join (and the
    anti join at the same shape) with the left-only expand; the one-key
    semi and anti joins of the semi_anti path on one SF10 batch."""
    scols = int_cols(item_triples(tables, 1 + rng.randint(
        0, ITEM_ROWS, Q14A_STREAM)), dev)
    bcols = int_cols(item_triples(tables, 1 + rng.randint(
        0, ITEM_ROWS, Q14A_BUILD)), dev)
    build = JK.build_side(keys_batch(bcols), [0, 1, 2])
    sb = keys_batch(scols)
    packed = [torch.from_numpy(pack3(*[c.to_numpy()[0] for c in cols])
                               ).to(dev) for cols in (scols, bcols)]
    lib_build = torch.sort(packed[1])[0]
    ones = torch.ones(Q14A_STREAM, dtype=torch.bool, device=dev)
    n, nb, nw = Q14A_STREAM, build.num_rows, build.keys.shape[1]
    steps = max(nb, 1).bit_length()
    for join_type in SEMI_TYPES:
        off, total, li = hold_left_only(scols, build, join_type,
                                        f"the timed q14a {join_type}")
        name = probe_name(True, join_type)
        # the stream's key columns read, the build's words read once, the
        # 0/1 counts written; one binary search and one compare of nw words
        nbytes = 15 * n + (8 * nw + 1) * nb + 4 * (n + 1)
        ops = (steps + 1) * 2 * nw * n
        line = {"kernel": name, "shape": "q14a_cross_items", "n": n,
                "build": nb, "words": nw, "kept": total, **measure(
                    lambda: JK.join_probe(sb, [0, 1, 2], build, join_type),
                    lambda: JK.probe_multi_plain(
                        *JK.key_words_plain(scols, build.chunks), build,
                        join_type),
                    library_left_only(lib_build, packed[0], ones, join_type),
                    nbytes, ops)}
        emit(line)
        summary[name] = summarize(line, nbytes, ops)
        if join_type == "left_semi":
            nbytes = 4 * (n + 1) + 4 * total
            line = {"kernel": "join_expand_left_only",
                    "shape": "q14a_cross_items", "n": n, "kept": total,
                    **measure(
                        lambda: JK.join_expand(off[:0], off, total, build,
                                               join_type),
                        lambda: JK.expand_left_only_plain(off, total),
                        lambda: torch.nonzero(off[1:] != off[:-1]),
                        nbytes)}
            emit(line)
            summary["join_expand_left_only"] = summarize(line, nbytes)
    # one-key: store item keys against the hot items (category <= 3), store
    # date keys against the dates of 2000
    i, d = tables[3], tables[2]
    shapes = {
        "left_semi": ("semi_anti_hot_items",
                      1 + rng.randint(0, ITEM_ROWS, N),
                      i["i_item_sk"][i["i_category_id"] <= 3]),
        "left_anti": ("semi_anti_year_2000",
                      2450000 + rng.randint(0, 6 * 365, N),
                      d["d_date_sk"][d["d_year"] == 2000])}
    for join_type, (shape, skeys, bkeys) in shapes.items():
        stream = DeviceColumn.from_numpy(skeys.astype(np.int32), T.INT, None,
                                         dev)
        bcol = DeviceColumn.from_numpy(bkeys.astype(np.int32), T.INT, None,
                                       dev)
        build = JK.build_side(build_batch(bcol), 0)
        _, total, li = hold_left_only([stream], build, join_type, shape)
        want = numpy_kept([stream], [bcol], join_type)
        require(total == len(want), f"{shape}: {total} kept, numpy "
                f"{len(want)}")
        nb = build.num_rows
        steps = max(nb, 1).bit_length()
        nbytes, ops = 5 * N + 9 * nb + 4 * (N + 1), (steps + 1) * 4 * N
        name = probe_name(False, join_type)
        sorted_keys = torch.from_numpy(np.sort(bkeys.astype(np.int64))
                                       ).to(dev)
        line = {"kernel": name, "shape": shape, "n": N, "build": nb,
                "kept": total, **measure(
                    lambda: JK.join_probe(build_batch(stream), 0, build,
                                          join_type),
                    lambda: JK.probe_plain(stream, build, join_type),
                    library_left_only(sorted_keys, stream.data.long(),
                                      stream.validity, join_type),
                    nbytes, ops)}
        emit(line)
        summary[name] = summarize(line, nbytes, ops)


# -- phase 3: the q19 path's substring -----------------------------------------

SUB_POSITIONS = (-70, -3, -1, 0, 1, 2, 5, 100)
SUB_LENGTHS = (-1, 0, 1, 3, 5, 2**30, 2**31 - 1, None)   # None: absent
SUB_EDGES = [b"", b"\x80", b"\x80a", "\u00e9\u00e9".encode(), None,
             b"hello", "h\u00e9llo".encode(), "\U0001f600".encode()]


def utf8_column(rng, n: int, dev, null_frac=0.1, max_chars=16,
                lone=0.02) -> DeviceColumn:
    """n strings of 0..max_chars characters of 1-4 UTF-8 bytes (at most 64
    bytes a row), null_frac nulls; a ``lone`` share of the characters is
    a lone continuation byte (0x80-0xBF, no character start)."""
    chars = rng.randint(0, max_chars + 1, n)
    valid = rng.rand(n) >= null_frac
    chars[~valid] = 0
    total = int(chars.sum())
    width = rng.randint(1, 5, total)
    lone_char = rng.rand(total) < lone
    width[lone_char] = 1
    starts = np.zeros(total + 1, np.int64)
    np.cumsum(width, out=starts[1:])
    data = rng.randint(0x80, 0xC0, int(starts[-1])).astype(np.uint8)
    lo = np.array([0, 0x20, 0xC2, 0xE1, 0xF0])
    hi = np.array([0, 0x7F, 0xE0, 0xED, 0xF4])
    lead = rng.randint(lo[width], hi[width]) if total else width
    data[starts[:-1]] = np.where(lone_char, rng.randint(0x80, 0xC0, total),
                                 lead)
    bounds = np.zeros(n + 1, np.int64)
    np.cumsum(chars, out=bounds[1:])
    return DeviceColumn.from_string_buffers(starts[bounds].astype(np.int32),
                                            data, valid, dev)


def one_value(v, dev) -> torch.Tensor:
    return torch.full((1,), SS.NO_LENGTH if v is None else v,
                      dtype=torch.int32, device=dev)


def hold_substring(col, pos, length, what: str) -> None:
    got = SS.substring(col, pos, length)
    want = SS.substring_plain(col, pos, length)
    require(int(got.offsets[0]) == 0, f"substring offsets start at "
            f"{int(got.offsets[0])}: {what}")
    hold("substring", string_pairs(got, want), what)


def substring_bytes(col, out, per_row: bool) -> int:
    """What a substring must move: the offsets, the input bytes and the
    validity read once, the new offsets and bytes written once (pos and
    len as columns: 4 bytes a row each)."""
    n = col.num_rows
    nin = int(col.offsets[-1] - col.offsets[0]) if n else 0
    return (4 * (n + 1) + nin + n + 4 * (n + 1) + int(out.offsets[-1])
            + (8 * n if per_row else 0))


def time_substring(c, label: str) -> tuple:
    """SUBSTRING(c, 1, 5) held against its plain version and timed: the
    phase line and the bytes of its bound."""
    one, five = one_value(1, c.device), one_value(5, c.device)
    hold_substring(c, one, five, f"the timed {label}")
    nbytes = substring_bytes(c, SS.substring(c, one, five), False)
    line = {"kernel": "substring", "shape": label, "n": c.num_rows,
            "pos": 1, "len": 5, **measure(
                lambda: SS.substring(c, one, five),
                lambda: SS.substring_plain(c, one, five), None, nbytes)}
    emit(line)
    return line, nbytes


def time_substring_q19(dev, gauntlet, summary) -> None:
    """SUBSTRING timed at q19's shape: the ca_zip strings its filter gets
    in one call at SF10, which the numpy side of phase 7 collected (the
    rows of store_sales' first partition that q19's date, item and
    customer joins keep, as the joins' gather lays them out)."""
    zips = np.concatenate(gauntlet.q19_zips)
    line, nbytes = time_substring(DeviceColumn.from_strings(
        [f"{z:05d}" for z in zips.tolist()], dev), "q19_filter")
    summary["substring"] = summarize(line, nbytes)


def check_substring(rng, dev) -> None:
    """Bit for bit against the plain version (offsets, bytes, validity):
    n = 1,048,576, 1,000,003 and 0 of utf8_column (and the edges), every
    literal pos against every literal len, pos and len as per-row columns,
    the same on a slice whose offsets start past 0; then timed at
    1,048,576 five-byte zips (at q19's shape after phase 7)."""
    lengths = [SS.NO_LENGTH if v is None else v for v in SUB_LENGTHS]
    for n in (N, RAGGED, 0):
        col = utf8_column(rng, n, dev)
        if n == N:
            col = S.concat_column_plain([col, DeviceColumn.from_strings(
                SUB_EDGES, dev)])
        m = col.num_rows
        parts = [("whole", col)]
        if m:
            parts.append(("slice", col.slice_rows(1_000, m - 777)))
            require(int(parts[1][1].offsets[0]) > 0, "the slice starts at 0")
        for label, c in parts:
            k = c.num_rows
            for pos in SUB_POSITIONS:
                for ln in SUB_LENGTHS:
                    hold_substring(c, one_value(pos, dev), one_value(ln, dev),
                                   f"n={k} {label} pos={pos} len={ln}")
            pos = torch.from_numpy(rng.choice(SUB_POSITIONS, k).astype(
                np.int32)).to(dev)
            ln = torch.from_numpy(rng.choice(lengths, k).astype(
                np.int32)).to(dev)
            hold_substring(c, pos, ln, f"n={k} {label} per-row pos and len")
    zips = DeviceColumn.from_string_buffers(
        np.arange(0, 5 * N + 1, 5, dtype=np.int32),
        rng.randint(0x30, 0x3A, 5 * N).astype(np.uint8),
        rng.rand(N) >= 0.02, dev)
    time_substring(zips, "zip_5_bytes")


# -- phase 3: the fused segment ---------------------------------------------

FUSED_SELECTIVITIES = (0.0, SEL_Q6, 0.5, 1.0)


def fused_table(rng, n: int, dev) -> ColumnarBatch:
    """Columns for every instruction, 10% nulls each: int32 and int64 near
    their limits (sums and products wrap), doubles with NaN, -0.0 and
    infinities, bools, decimals at scales 0, 2 and 4 whose rescaled
    compares tie, dates; and ``u`` uniform in [0, 1) with no nulls, which
    a filter ``u < p`` keeps at selectivity p."""
    i32, i64 = np.iinfo(np.int32), np.iinfo(np.int64)

    def ints(edge, dtype):
        v = rng.randint(-9, 9, n).astype(dtype)
        pick = rng.rand(n) < 0.2
        v[pick] = rng.choice(np.array(edge, dtype=dtype), pick.sum())
        return v

    def doubles():
        v = np.round(rng.uniform(-4, 4, n), 1)
        pick = rng.rand(n) < 0.25
        v[pick] = rng.choice(np.array([np.nan, -0.0, 0.0, np.inf, -np.inf]),
                             pick.sum())
        return v
    d2 = rng.randint(-500, 500, n).astype(np.int64)
    cols = {"i": ints([i32.max, i32.min, 46341], np.int32),
            "j": ints([i32.max, 1, 46341], np.int32),
            "l": ints([i64.max, i64.min, 3037000500], np.int64),
            "m": ints([i64.max, 2, 3037000500], np.int64),
            "x": doubles(), "y": doubles(),
            "b": rng.rand(n) < 0.5, "c": rng.rand(n) < 0.5,
            "d0": rng.randint(-5, 5, n).astype(np.int64), "d2": d2,
            "d4": np.where(rng.rand(n) < 0.5, d2 * 100,
                           rng.randint(-50_000, 50_000, n)),
            "dt": rng.randint(8000, 8010, n).astype(np.int32)}
    types = {"i": T.INT, "j": T.INT, "l": T.LONG, "m": T.LONG,
             "x": T.DOUBLE, "y": T.DOUBLE, "b": T.BOOLEAN, "c": T.BOOLEAN,
             "d0": T.DecimalType(10, 0), "d2": T.DecimalType(12, 2),
             "d4": T.DecimalType(14, 4), "dt": T.DATE, "u": T.DOUBLE}
    arrays = {k: (v, rng.rand(n) >= 0.1) for k, v in cols.items()}
    arrays["u"] = rng.rand(n)
    return batch_from_numpy(arrays, Schema(tuple(types),
                                           tuple(types.values())), dev)


def every_instruction() -> list:
    """Expressions whose programs hold every instruction."""
    c, lit = E.col, E.lit
    dbl = [E.Cast(c(d), T.DOUBLE) for d in ("d0", "d2", "d4")]
    return [c("i") + c("j"), c("i") - lit(7), c("i") * c("j"),
            c("l") * c("m"), c("i") + c("l"), c("dt") - c("dt"),
            c("i") + c("x"), c("l") * c("y"), c("x") * c("y") + c("x"),
            lit(1.0) - c("x"), *dbl,
            dbl[1] * (lit(1.0) - dbl[2]) * (lit(1.0) + dbl[0]),
            c("i") < c("j"), c("i") <= c("l"), E.GreaterThan(c("x"), c("y")),
            c("x") >= c("y"), c("x") == c("y"), c("i") < c("x"),
            c("dt") == lit(8004, T.DATE), c("b") < c("c"),
            c("d2") < c("d4"), c("d2") == c("d4"),
            c("d0") >= lit(150, T.DecimalType(12, 2)), c("b") & c("c"),
            (c("i") < c("j")) & (c("x") > c("y")), E.IsNull(c("x")),
            E.If(c("b"), c("i"), c("j")),
            E.If(c("i") < c("j"), c("x"), c("l")),
            E.If(E.IsNull(c("x")), lit(1), lit(0))]


def bool_instructions() -> list:
    """Expressions whose programs hold OR and NOT over bools with nulls
    (every_instruction's program is at the kernel's 32 outputs)."""
    c = E.col
    return [c("b") | c("c"), ~c("b"), c("x") != c("y"),
            ~((c("i") < c("j")) | E.IsNull(c("x"))),
            (c("b") | E.IsNull(c("c"))) & ~c("c")]


def bool_program(schema, p):
    """The compact program of bool_instructions; the filter ``u < p``."""
    b = P.ProgramBuilder(schema.dtypes)
    cols = [P.Column(dt, ordinal=i) for i, dt in enumerate(schema.dtypes)]

    def value(e):
        return b.value(e.bind(schema), cols)
    keep = None if p is None else value(E.col("u") < E.lit(float(p)))
    return b.finish(keep, [value(e) for e in bool_instructions()], [])


def fused_programs(schema, p) -> tuple:
    """(compact program, global program) over ``schema``; the filter is
    ``u < p`` (None: no filter)."""
    out = []
    for mode in ("compact", "global"):
        b = P.ProgramBuilder(schema.dtypes)
        cols = [P.Column(dt, ordinal=i) for i, dt in enumerate(schema.dtypes)]

        def value(e):
            return b.value(e.bind(schema), cols)
        keep = None if p is None else value(E.col("u") < E.lit(float(p)))
        if mode == "compact":
            out.append(b.finish(keep, [value(e) for e in every_instruction()],
                                []))
            continue
        sq = E.Cast(E.col("d2"), T.DOUBLE)
        slots = [(value(sq * sq), P.SUM_F64),
                 (value(E.col("i") + E.col("j")), P.SUM_I64),
                 (value(E.col("x")), P.SUM_NONE),
                 (value(E.If(E.IsNull(E.col("x")), E.lit(0.0), E.col("u"))),
                  P.SUM_F64),
                 (value(E.col("dt")), P.SUM_F64)]
        out.append(b.finish(keep, [], slots))
    return tuple(out)


def hold_compact(prog, batch, need_map: bool, what: str) -> int:
    """The kernel's compact mode against the plain version: every output's
    data and validity, the map and the count, bit for bit."""
    words = prog.words().to(batch.device)
    n = batch.num_rows
    outs, idx, count = FK.fused_compact(prog, words, batch.columns, n,
                                        need_map)
    w_outs, w_idx, w_count = FK.fused_compact_plain(
        prog, batch.columns, n, need_map, batch.device)
    require(count == w_count, f"fused_segment count {count} != {w_count}: "
            f"{what}")
    require((idx is None) == (w_idx is None), f"fused_segment map: {what}")
    pairs = [p for (x, v), (wx, wv) in zip(outs, w_outs, strict=True)
             for p in ((x, wx), (v, wv))]
    if idx is not None:
        pairs.append((idx, w_idx))
    hold("fused_segment", pairs, what)
    return count


def hold_global(prog, batch, what: str) -> None:
    """Global mode against the plain version: counts, flags and int64 sums
    bit for bit; f64 sums within F64_RTOL_KERNEL (the kernel adds per
    thread, per block and over the tiles, the plain version in torch.sum's
    order)."""
    words = prog.words().to(batch.device)
    n = batch.num_rows
    got = FK.fused_global(prog, words, batch.columns, n)
    want = FK.fused_global_plain(prog, batch.columns, n, batch.device)
    exact = [(got.kept, want.kept), (got.one, want.one)]
    f64 = []
    for g, w, (_, _, sum_kind) in zip(got.slots, want.slots, prog.slots,
                                      strict=True):
        exact += [(g.ok, w.ok), (g.count, w.count)]
        (f64 if sum_kind == P.SUM_F64 else exact).append((g.value, w.value))
    hold("fused_segment", exact, what)
    if f64:
        hold("fused_segment", f64, what, F64_RTOL_KERNEL)


def query_segment(query, batch):
    """The fused segment the planner makes of a query over one batch (in
    two partitions, so that the aggregate splits)."""
    df = GpuSession().create_dataframe([batch], num_partitions=2)
    segs = [n for n in plan_nodes(query(df).physical_plan())
            if isinstance(n, GpuFusedSegmentExec)]
    require(len(segs) == 1, f"{len(segs)} fused segments, not 1")
    return segs[0].segment


def fused_bytes(prog, batch, count: int, need_map: bool) -> int:
    """What a call must move: each loaded column's data and validity once,
    each output (and the map) once for the kept rows."""
    n = batch.num_rows
    read = sum((batch.columns[o].data.element_size() + 1) * n
               for o in prog.loads)
    width = sum(torch.tensor([], dtype=P.KIND_DTYPE[k]).element_size() + 1
                for _, k in prog.outputs) + (4 if need_map else 0)
    return read + count * width + 17 * len(prog.slots) + 9


def check_decimal_cast(rng, dev) -> None:
    """Decimal -> double divides by 10**scale: the per-op ``Cast`` and the
    fused kernel's CAST_DEC_F64 on the card both equal numpy's division
    bit for bit at scales 0, 2 and 4 (0.05 and 0.07 among the values),
    where a multiply by the reciprocal, which PyTorch's CUDA division by a
    host scalar does, differs in the last bit; that count is printed."""
    vals = np.concatenate([np.arange(-1000, 1000),
                           rng.randint(-10**12, 10**12, N)]).astype(np.int64)
    for scale in (0, 2, 4):
        dt = T.DecimalType(18, scale)
        batch = batch_from_numpy({"d": vals}, Schema(("d",), (dt,)), dev)
        want = torch.from_numpy(vals / 10.0 ** scale).to(dev)
        e = E.Cast(E.col("d"), T.DOUBLE).bind(batch.schema)
        b = P.ProgramBuilder(batch.schema.dtypes)
        prog = b.finish(None, [b.value(e, [P.Column(dt, ordinal=0)])], [])
        (got, _), = FK.fused_compact(prog, prog.words().to(dev),
                                     batch.columns, len(vals), False)[0]
        per_op = e.eval(EvalContext(batch)).data
        require(torch.equal(bits(got), bits(want)),
                f"fused CAST_DEC_F64 at scale {scale} is not a division")
        require(torch.equal(bits(per_op), bits(want)),
                f"Cast at scale {scale} is not a division")
        by_scalar = batch.columns[0].data.to(torch.float64) / 10 ** scale
        emit({"check": "decimal_cast", "scale": scale, "values": len(vals),
              "host_scalar_divisor_differs":
                  int((bits(by_scalar) != bits(want)).sum())})


def check_fused(rng, dev, summary) -> None:
    """Both modes on every instruction at n = 1,048,576 and 1,000,003 at
    selectivities 0%, 1.8%, 50% and 100% and with no filter, on an empty
    batch, then q6's program (global) and q1's (compact, with the gather
    map) on the first SF10 batch, which are timed."""
    check_decimal_cast(rng, dev)
    for n in (N, RAGGED, 0):
        batch = fused_table(rng, n, dev)
        for p in FUSED_SELECTIVITIES + (None,):
            compact, glob = fused_programs(batch.schema, p)
            what = f"n={n} p={p}"
            count = hold_compact(compact, batch, True, what + " compact")
            want = int((batch.column("u").data < p).sum()) if p is not None \
                else n
            require(count == want, f"fused_segment kept {count} of {want}")
            require(hold_compact(bool_program(batch.schema, p), batch, True,
                                 what + " OR / NOT") == want,
                    "fused_segment's OR / NOT program kept another count")
            hold_global(glob, batch, what + " global")
    chunk = next(tpch.iter_lineitem(SF10_ROWS, seed=42, batch_rows=N))
    batch = batch_from_numpy(chunk, tpch.LINEITEM_SCHEMA, dev)
    for name, query, is_global in (("q6", tpch.q6, True),
                                   ("q1", tpch.q1, False)):
        seg = query_segment(query, batch)
        prog = seg.program
        require(seg.is_global == is_global, f"{name}'s segment mode")
        words = prog.words().to(dev)
        cols = batch.columns
        if is_global:
            hold_global(prog, batch, f"{name} program")
            count = N
            kernel = lambda: FK.fused_global(prog, words, cols, N)  # noqa
            plain = lambda: FK.fused_global_plain(prog, cols, N, dev)  # noqa
        else:
            count = hold_compact(prog, batch, True, f"{name} program")
            kernel = lambda: FK.fused_compact(  # noqa: E731
                prog, words, cols, N, True)
            plain = lambda: FK.fused_compact_plain(  # noqa: E731
                prog, cols, N, True, dev)
        nbytes = fused_bytes(prog, batch, 0 if is_global else count,
                             not is_global)
        line = {"kernel": "fused_segment", "shape": f"{name}_batch",
                "mode": "global" if is_global else "compact", "n": N,
                "kept": count, "instructions": len(prog.code),
                "registers": prog.n_regs, "loads": len(prog.loads),
                **measure(kernel, plain, None, nbytes)}
        emit(line)
        if is_global:
            summary["fused_segment"] = summarize(line, nbytes)


# -- phase 3: the picks and bitwise reductions (phase 13's path) --------------

PICK_KEY_TYPES = (T.BOOLEAN, T.BYTE, T.SHORT, T.INT, T.LONG, T.FLOAT,
                  T.DOUBLE)
BIT_TYPES = (T.BYTE, T.SHORT, T.INT, T.LONG)
BIT_OPS = ("bit_and", "bit_or", "bit_xor")
#: binaryCompare's edges beside the random strings: a trailing NUL, the
#: empty string before a one-byte one
PICK_STRING_EDGES = STRING_EDGES + ["a", "", "ab", "ab\x00", "a", ""]


def pick_column(rng, n: int, dtype: T.DataType, dev) -> DeviceColumn:
    """10% nulls; half the rows from seven small values, so that keys tie;
    floats with NaN, infinities and both zeros."""
    if dtype in (T.FLOAT, T.DOUBLE):
        vals = rng.randn(n) * 1e3
        pick = rng.rand(n) < 0.1
        vals[pick] = rng.choice(SPECIAL_FLOATS, int(pick.sum()))
    elif dtype == T.BOOLEAN:
        vals = rng.rand(n) < 0.5
    else:
        info = np.iinfo(dtype.np_dtype)
        vals = rng.randint(info.min, info.max, n, dtype=np.int64)
    if dtype != T.BOOLEAN:
        few = rng.rand(n) < 0.5
        vals[few] = rng.randint(-3, 4, int(few.sum()))
    valid = rng.rand(n) >= 0.1
    vals = np.where(valid, vals.astype(dtype.np_dtype),
                    np.zeros((), dtype.np_dtype))
    return DeviceColumn.from_numpy(vals, dtype, valid, dev)


def pick_layouts(rng, n: int) -> dict:
    """Segment starts: 14 segments, and ~n/2 of one or two rows."""
    out = {}
    if n >= 14:
        out["fourteen"] = np.r_[0, np.sort(rng.choice(np.arange(1, n), 13,
                                                      replace=False))]
    pairs = np.r_[0, np.cumsum(rng.randint(1, 3, n))]
    out["pairs"] = pairs[pairs < n]
    return out


def null_segment(c: DeviceColumn, starts: np.ndarray) -> DeviceColumn:
    """Segment 2 all null (a null row's bytes and data zero)."""
    if len(starts) < 4:
        return c
    a, b = int(starts[2]), int(starts[3])
    if c.is_string:
        keep = torch.ones(c.num_rows, dtype=torch.bool, device=c.device)
        keep[a:b] = False
        idx = torch.where(keep, torch.arange(c.num_rows, device=c.device),
                          -1).to(torch.int32)
        return S.gather_columns_plain([c], idx)[0]
    c.validity[a:b] = False
    c.data[a:b] = 0
    return c


def hold_pick(c: DeviceColumn, st: torch.Tensor, pick: str, what: str,
              **kw) -> None:
    """segmented_pick and masked_pick against their plain versions, with
    ``c`` the value (first / last) or the key (min / max)."""
    if pick in ("first", "last"):
        args = (pick, c.validity)
        key = ()
    else:
        args = (pick, c.validity)
        key = (c.data, c.offsets) if c.is_string else (c.data,)
    hold("segmented_pick", [(
        R.segmented_pick(*args, st, *key, **kw),
        R.segmented_pick_plain(*args, st, *key, **kw))], what)
    hold("masked_pick", [(
        R.masked_pick(*args, *key, **kw),
        R.masked_pick_plain(*args, *key, **kw))], what)


def hold_bitwise(c: DeviceColumn, st: torch.Tensor, op: str,
                 what: str) -> None:
    hold("segmented_bitwise", list(zip(
        R.segmented_bitwise(op, c.data, c.validity, st),
        R.segmented_bitwise_plain(op, c.data, c.validity, st))), what)
    hold("masked_bitwise", list(zip(
        R.masked_bitwise(op, c.data, c.validity),
        R.masked_bitwise_plain(op, c.data, c.validity))), what)


def phase13_layout(rng, n: int, dev):
    """A partial step's work at phase 13's shape: a batch of the tail's
    table (``held.tail_columns``) sorted by its 9 keys: v, x, s and b."""
    data, validity = held.tail_columns(n, int(rng.randint(1 << 30)))
    order = np.argsort(data["k"], kind="stable")
    keys = data["k"][order]
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    types = dict(zip(held.TAIL_SCHEMA.names, held.TAIL_SCHEMA.dtypes))
    cols = {c: DeviceColumn.from_numpy(data[c][order], types[c],
                                       validity[c][order], dev)
            for c in "vxb"}
    cols["s"] = DeviceColumn.from_string_buffers(*held.tail_strings(
        data["s"][order], validity["s"][order]), dev)
    return cols, torch.from_numpy(starts.astype(np.int32)).to(dev)


def check_picks(rng, dev, summary) -> None:
    """segmented_pick, masked_pick, segmented_bitwise and masked_bitwise
    against their plain versions, bit for bit: n = 1,048,576, 1,000,003
    and 0; 14 segments and ~n/2 of one or two rows, one all null; 10%
    nulls and ties; first / last with and without ignore_nulls; min / max
    keys over bool, int8, int16, int32, int64, float and double (NaN,
    infinities, both zeros) in both NaN modes and over strings of 0-64
    bytes (bytes >= 0x80, shared prefixes, binaryCompare's edges); AND /
    OR / XOR at every integral width.  Then each timed at phase 13's
    partial shape (the kernels line: the pick over the double ``x``, the
    XOR over the long ``v``; the position and string picks beside)."""
    for n in (N, RAGGED, 0):
        for name, starts in pick_layouts(rng, n).items():
            st = torch.from_numpy(starts.astype(np.int32)).to(dev)
            what = f"n={n} {name}"
            val = null_segment(pick_column(rng, n, T.LONG, dev), starts)
            for pick in ("first", "last"):
                for ignore in (False, True):
                    hold_pick(val, st, pick, f"{what} {pick} "
                              f"ignore_nulls={ignore}", ignore_nulls=ignore)
            for dt in PICK_KEY_TYPES:
                key = null_segment(pick_column(rng, n, dt, dev), starts)
                for nan_greatest in ((True, False) if dt.is_floating
                                     else (True,)):
                    for pick in ("min", "max"):
                        hold_pick(key, st, pick, f"{what} {dt!r} {pick} "
                                  f"nan_greatest={nan_greatest}",
                                  nan_greatest=nan_greatest)
            for dt in BIT_TYPES:
                c = null_segment(pick_column(rng, n, dt, dev), starts)
                for op in BIT_OPS:
                    hold_bitwise(c, st, op, f"{what} {dt!r} {op}")
        strings = S.concat_column_plain([string_column(rng, n, dev),
                                         DeviceColumn.from_strings(
                                             PICK_STRING_EDGES, dev)])
        for name, starts in pick_layouts(rng, strings.num_rows).items():
            st = torch.from_numpy(starts.astype(np.int32)).to(dev)
            c = null_segment(strings, starts)
            for pick in ("min", "max"):
                hold_pick(c, st, pick, f"n={n} {name} strings {pick}")
    cols, st = phase13_layout(rng, N, dev)
    g = st.shape[0]
    x, v, s = cols["x"], cols["v"], cols["s"]
    str_bytes = N + 4 * (N + 1) + int(s.data.shape[0]) + 8 * g
    cases = {
        "segmented_pick": (
            lambda: R.segmented_pick("max", x.validity, st, x.data),
            lambda: R.segmented_pick_plain("max", x.validity, st, x.data),
            None, 9 * N + 8 * g),
        "masked_pick": (
            lambda: R.masked_pick("max", x.validity, x.data),
            lambda: R.masked_pick_plain("max", x.validity, x.data),
            lambda: torch.argmax(x.data), 9 * N + 4),
        "segmented_bitwise": (
            lambda: R.segmented_bitwise("bit_xor", v.data, v.validity, st),
            lambda: R.segmented_bitwise_plain("bit_xor", v.data, v.validity,
                                              st),
            None, 9 * N + 4 * g + 9 * g),
        "masked_bitwise": (
            lambda: R.masked_bitwise("bit_xor", v.data, v.validity),
            lambda: R.masked_bitwise_plain("bit_xor", v.data, v.validity),
            None, 9 * N + 9),
    }
    # beside the kernels line: the position kind and the string kind
    extra = {
        "segmented_pick[first_valid]": (
            lambda: R.segmented_pick("first", v.validity, st,
                                     ignore_nulls=True),
            lambda: R.segmented_pick_plain("first", v.validity, st,
                                           ignore_nulls=True),
            None, N + 8 * g),
        "masked_pick[first_valid]": (
            lambda: R.masked_pick("first", v.validity, ignore_nulls=True),
            lambda: R.masked_pick_plain("first", v.validity,
                                        ignore_nulls=True),
            None, N + 4),
        "segmented_pick[string]": (
            lambda: R.segmented_pick("max", s.validity, st, s.data,
                                     s.offsets),
            lambda: R.segmented_pick_plain("max", s.validity, st, s.data,
                                           s.offsets),
            None, str_bytes),
        "masked_pick[string]": (
            lambda: R.masked_pick("max", s.validity, s.data, s.offsets),
            lambda: R.masked_pick_plain("max", s.validity, s.data,
                                        s.offsets),
            None, str_bytes - 8 * g + 4),
    }
    for pick in ("first", "max"):
        hold_pick(x, st, pick, "phase 13's shape x")
    hold_pick(s, st, "max", "phase 13's shape s")
    hold_bitwise(v, st, "bit_xor", "phase 13's shape v")
    for kernel, (fn, plain, library, nbytes) in {**cases, **extra}.items():
        line = {"kernel": kernel, "shape": "phase13_partial", "n": N,
                "segments": g, **measure(fn, plain, library, nbytes, N)}
        emit(line)
        if kernel in cases:
            summary[kernel] = summarize(line, nbytes, N)


# -- phase 3: the Decimal128 kernels (phase 14's and 15's paths) -------------

DEC_EDGES = [0, 1, -1, 5, -5, 15, -15, 25, -25, 10**38 - 1, -(10**38 - 1),
             -(1 << 127), (1 << 127) - 1, 10**37, -(10**37), 10**19,
             -(10**19), 2**63 - 1, -(2**63), 10**18 - 1]


def dec_plane(rng, n: int, two: bool, dev) -> torch.Tensor:
    """n seeded decimals of every magnitude up to int128's (an [n, 2] plane;
    one limb: int64 [n]), the edges first."""
    lo = rng.randint(-2**63, 2**63 - 1, n, dtype=np.int64)
    if two:
        hi = rng.randint(-2**62, 2**62, n, dtype=np.int64) >> \
            rng.randint(0, 63, n)
        small = rng.rand(n) < 0.3                    # one-limb magnitudes
        hi = np.where(small, lo >> 63, hi)
        vals = np.stack([lo, hi], 1)
        edges = [const128(v) for v in DEC_EDGES]
    else:
        vals = lo >> rng.randint(0, 63, n)
        edges = [v for v in DEC_EDGES if -2**63 <= v < 2**63]
    m = min(len(edges), n)
    vals[:m] = np.array(edges[:m], np.int64).reshape(vals[:m].shape)
    return torch.from_numpy(vals).to(dev)


def dec_valid(rng, n: int, dev) -> torch.Tensor:
    v = rng.rand(n) >= 0.1
    v[:len(DEC_EDGES)] = True
    return torch.from_numpy(v).to(dev)


def hold_binary(what: str, *args, **kw) -> None:
    got = DK.decimal128_binary(*args, **kw)
    want = DK.decimal128_binary_plain(*args, **kw)
    hold("decimal128_binary", list(zip(got, want)), what)


def hold_divide(what: str, *args, **kw) -> None:
    got = DK.decimal128_divide(*args, **kw)
    want = DK.decimal128_divide_plain(*args, **kw)
    hold("decimal128_divide", list(zip(got, want)), what)


def hold_sum128(x, v, st, precision, count, what: str) -> None:
    hold("segmented_sum128", list(zip(
        R.segmented_sum128(x, v, st, precision, count),
        R.segmented_sum128_plain(x, v, st, precision, count))), what)
    hold("masked_sum128", list(zip(
        R.masked_sum128(x, v, precision, count),
        R.masked_sum128_plain(x, v, precision, count))), what)


def hold_extreme128(x, v, st, what: str) -> None:
    for is_min in (True, False):
        w = f"{what} {'min' if is_min else 'max'}"
        hold("segmented_extreme128", list(zip(
            R.segmented_extreme128(x, v, st, is_min),
            R.segmented_extreme128_plain(x, v, st, is_min))), w)
        hold("masked_extreme128", list(zip(
            R.masked_extreme128(x, v, is_min),
            R.masked_extreme128_plain(x, v, is_min))), w)


def check_decimal_elementwise(rng, dev) -> None:
    """decimal128_binary and decimal128_divide bit for bit (limbs and
    validity) against their plain versions at n = 1,000,003 and 0 (and
    n = 1,048,576 at the timed shapes):
    one- and two-limb operands, every op, every precision mode, rescales
    up to 10**38, divides with shifts to 40 (two-staged past 38), zero
    divisors, ties."""
    n = RAGGED
    a2, b2 = dec_plane(rng, n, True, dev), dec_plane(rng, n, True, dev)
    a1, b1 = dec_plane(rng, n, False, dev), dec_plane(rng, n, False, dev)
    va, vb = dec_valid(rng, n, dev), dec_valid(rng, n, dev)
    for an, a in (("a2", a2), ("a1", a1)):
        for bn, b in (("b2", b2), ("b1", b1)):
            for op in (DK.ADD, DK.SUB, DK.MUL):
                for p in (38, 20, DK.INT128, DK.WRAP):
                    for ka, kb in ((0, 0), (4, 2), (0, 38)):
                        if op == DK.MUL and (ka or kb):
                            continue
                        hold_binary(f"n={n} op {op} {an} {bn} p={p} "
                                    f"k={ka},{kb}", op, a, va, b, vb, ka,
                                    kb, p)
        for k in (0, 1, 18, 19, 38):
            for p in (38, 30, DK.WRAP):
                hold_binary(f"n={n} rescale {an} k={k} p={p}",
                            DK.RESCALE, a, va, ka=k, precision=p)
        for s in (0, 2, 4, 38):
            hold_binary(f"n={n} to_double {an} s={s}", DK.TO_DOUBLE, a,
                        va, ka=s)
        hold_binary(f"n={n} mul {an} narrow", DK.MUL, a, va, b1, vb,
                    precision=16, out_two=False)
    b2[7::13] = 0                       # zero divisors
    b1[7::13] = 0
    ties = torch.tensor([5, -5, 15, -25], dtype=torch.int64, device=dev)
    a1[:4] = ties
    b1[:4] = 10
    for (an, a), (bn, b) in ((("a2", a2), ("b1", b1)),
                             (("a2", a2), ("b2", b2)),
                             (("a1", a1), ("b1", b1))):
        for shift in (0, 13, 40):
            for p in (38, 16, DK.INT128):
                hold_divide(f"n={n} {an}/{bn} shift={shift} p={p}", a,
                            va, b, vb, shift, p)
        hold_divide(f"n={n} {an}/{bn} truncating", a, va, b, vb,
                    half_up=False, precision=DK.INT128)
    counts = torch.from_numpy(rng.randint(1, 2**31, n).astype(
        np.int64)).to(dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    hold_divide(f"n={n} by counts", a2, va, counts, ones, 0, 38)
    for drop in (1, 9, 10, 20, 38):
        hold_divide(f"n={n} rescale down {drop}", a2, va, 10 ** drop,
                    precision=DK.INT128, out_two=drop < 20)
    z = torch.zeros((0, 2), dtype=torch.int64, device=dev)
    zv = torch.zeros(0, dtype=torch.bool, device=dev)
    hold_binary("n=0", DK.ADD, z, zv, z, zv)
    hold_divide("n=0", z, zv, z, zv, 6)


def dec_layouts(n: int) -> dict:
    """tail_layouts, and segments of ~80,000 rows."""
    out = tail_layouts(n)
    if n > 80_000:
        out["long"] = np.arange(0, n, 80_000)
    return out


def check_decimal_reductions(rng, dev) -> None:
    """segmented_sum128 / masked_sum128 and segmented_extreme128 /
    masked_extreme128 bit for bit: n = 0, 1 and 1,000,003 (1,048,576 at
    the timed shapes);
    segments of one row, of 7 (the first all null), ~1,000 random and of
    ~80,000 rows; one- and two-limb rows with the edges (sums past int128
    and past the precision); the merge with its counts (a null partial of
    a nonzero count poisons its segment)."""
    for n in (0, 1, RAGGED):
        for two in (True, False):
            x = dec_plane(rng, n, two, dev)
            v = dec_valid(rng, n, dev)[:n]
            count = torch.from_numpy(rng.randint(0, 3, n).astype(
                np.int64)).to(dev)
            for name, starts in dec_layouts(n).items():
                st = torch.from_numpy(starts.astype(np.int32)).to(dev)
                if name == "sevens" and n > 7:
                    v[:7] = False
                what = f"n={n} {name} two={two}"
                for p in (38, 22):
                    hold_sum128(x, v, st, p, None, f"{what} p={p}")
                hold_sum128(x, v, st, 38, count, f"{what} merge")
                hold_extreme128(x, v, st, what)


def dec_partial_layout(rng, n: int, dev):
    """A partial step's work: [n, 2] decimals sorted by 7 keys."""
    keys = np.sort(rng.randint(0, held.DEC_KEYS, n))
    starts = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
    x = dec_plane(rng, n, True, dev)
    x[:, 1] = x[:, 0] >> 63          # 64-bit magnitudes, as a money sum's
    return x, dec_valid(rng, n, dev), torch.from_numpy(
        starts.astype(np.int32)).to(dev)


def divide_steps(a: torch.Tensor, shift: int) -> int:
    """The long division's steps over these rows: the bit length of each
    |a| * 10**shift (the kernel starts at the numerator's top bit)."""
    lo, hi = a[:, 0].cpu().numpy(), a[:, 1].cpu().numpy()
    mag = np.abs(hi.astype(np.float64) * 2.0**64
                 + lo.view(np.uint64).astype(np.float64))
    bits = np.floor(np.log2(np.maximum(mag, 1.0) * 10.0 ** shift)) + 1
    return int(np.where(mag > 0, bits, 0).sum())


#: 64-bit operations a long-division step takes (a 128-bit shift, the bit,
#: a 128-bit compare and subtract, the quotient bit)
DIVIDE_STEP_OPS = 8
#: 64-bit operations of one two-limb multiply and its overflow test
MUL_OPS = 12


def check_decimal128(rng, dev, summary) -> None:
    """The four Decimal128 kernels (six wrappers) against their plain
    versions, then each timed at the shape its path gives it: q1_decimal's
    disc_price multiply (decimal(12,2) x decimal(13,2), 1,048,576 rows)
    and its sums' partial (1,048,576 two-limb rows in 7 segments); the
    held table's a / c (decimal(25,4) / decimal(12,2), shift 13), global
    sum and extremes over 1,048,576 rows."""
    check_decimal_elementwise(rng, dev)
    check_decimal_reductions(rng, dev)
    price = torch.from_numpy(np.round(rng.uniform(900, 105_000, N) * 100)
                             .astype(np.int64)).to(dev)
    disc = torch.from_numpy(100 - rng.randint(0, 11, N).astype(
        np.int64)).to(dev)
    ones = torch.ones(N, dtype=torch.bool, device=dev)
    hold_binary("q1_decimal's disc_price", DK.MUL, price, ones, disc, ones,
                precision=26)
    data, valid = held.decimal_columns(N, 5)
    a = torch.from_numpy(data["a"]).to(dev)
    va = torch.from_numpy(valid["a"]).to(dev)
    c = torch.from_numpy(data["c"]).to(dev)
    hold_divide("held's a / c", a, va, c, ones, 13, 38)
    x, v, st = dec_partial_layout(rng, N, dev)
    g = st.shape[0]
    hold_sum128(x, v, st, 36, None, "q1_decimal's partial")
    hold_extreme128(x, v, st, "the held partial")
    cases = {
        "decimal128_binary": (
            lambda: DK.decimal128_binary(DK.MUL, price, ones, disc, ones,
                                         precision=26),
            lambda: DK.decimal128_binary_plain(DK.MUL, price, ones, disc,
                                               ones, precision=26),
            35 * N, MUL_OPS * N, "q1_decimal_disc_price"),
        "decimal128_divide": (
            lambda: DK.decimal128_divide(a, va, c, ones, 13, 38),
            lambda: DK.decimal128_divide_plain(a, va, c, ones, 13, 38),
            43 * N, DIVIDE_STEP_OPS * divide_steps(a, 13), "held_a_div_c"),
        "segmented_sum128": (
            lambda: R.segmented_sum128(x, v, st, 36),
            lambda: R.segmented_sum128_plain(x, v, st, 36),
            17 * N + 4 * g + 18 * g, 3 * N, "q1_decimal_partial"),
        "masked_sum128": (
            lambda: R.masked_sum128(x, v, 38),
            lambda: R.masked_sum128_plain(x, v, 38),
            17 * N + 18, 3 * N, "held_global"),
        "segmented_extreme128": (
            lambda: R.segmented_extreme128(x, v, st, True),
            lambda: R.segmented_extreme128_plain(x, v, st, True),
            17 * N + 4 * g + 17 * g, 2 * N, "held_partial"),
        "masked_extreme128": (
            lambda: R.masked_extreme128(x, v, True),
            lambda: R.masked_extreme128_plain(x, v, True),
            17 * N + 17, 2 * N, "held_global"),
    }
    for kernel, (fn, plain, nbytes, ops, shape) in cases.items():
        line = {"kernel": kernel, "shape": shape, "n": N, "segments": g,
                **measure(fn, plain, None, nbytes, ops)}
        emit(line)
        summary[kernel] = summarize(line, nbytes, ops)


# -- phase 3: the window kernels (phases 16's and 17's paths) ------------------

LAYOUT_FIELDS = ("seg_start", "seg_end", "run_id", "run_first", "run_last")
WINDOW_ROWS_FRAMES = ((2, 0), (3, 3), (None, 0), (0, 2), (-1, 1), (5, -2),
                      (None, None))
WINDOW_RANGE_FRAMES = ((5, 5), (3, 0), (10, -2), (4, 4), (None, 3),
                       (2, None), (0, 0))
EXTREME_TYPES = (T.BOOLEAN, T.INT, T.LONG, T.FLOAT, T.DOUBLE)
# ROWS frames the extremes skip (the others cover clamped, empty and
# unbounded frames; the script's time)
EXTREME_SKIP = ("rows 3,3", "rows 0,2", "rows None,None")
F64_RTOL_FRAME = 1e-12           # of the prefix's sum of |x|
# phase 16's largest task partition: three of its 11 keys
WINDOW_KEY_ROWS = SF10_ROWS // 8 // 11            # one key: 681,956
WINDOW_SHAPE_ROWS = 3 * WINDOW_KEY_ROWS           # 2,045,868


def window_flags(rng, n: int, shape: str, dev):
    """(partition, peer) boundary flags: every row its own partition, one
    partition of all rows, or ~1,000 random partitions; peer runs of ~3
    rows inside them."""
    if shape == "one":
        part = np.ones(n, np.bool_)
    elif shape == "all":
        part = np.zeros(n, np.bool_)
    else:
        part = rng.rand(n) < 1e-3
    part[:1] = True
    peer = part | (rng.rand(n) < 0.3)
    return torch.from_numpy(part).to(dev), torch.from_numpy(peer).to(dev)


def hold_layout(part, peer, what: str):
    got = WK.window_layout(part, peer)
    want = WK.window_layout_plain(part, peer)
    hold("window_layout", [(getattr(got, f), getattr(want, f))
                           for f in LAYOUT_FIELDS], what)
    return got


def window_frames(rng, layout) -> list:
    """(name, lower, upper, max_len) on the card: the ROWS frames, the
    running RANGE frame, the whole partition and random frames (a fifth
    of them empty)."""
    out = []
    for pre, fol in WINDOW_ROWS_FRAMES:
        lo, up = WK.frame_bounds_rows(layout, pre, fol)
        bounded = pre is not None and fol is not None
        out.append((f"rows {pre},{fol}", lo, up,
                    max(pre + fol + 1, 1) if bounded else None))
    out.append(("running", layout.seg_start, layout.run_last, None))
    out.append(("whole", layout.seg_start, layout.seg_end - 1, None))
    n, dev = layout.n, layout.seg_start.device
    size = (layout.seg_end - layout.seg_start).long().clamp(min=1)
    a, b, e = (torch.from_numpy(x).to(dev) for x in (
        rng.randint(0, 2**30, n), rng.randint(0, 2**30, n), rng.rand(n) < 0.2))
    lo = layout.seg_start.long() + a % size
    up = layout.seg_start.long() + b % size
    lo, up = torch.minimum(lo, up), torch.maximum(lo, up)
    lo = torch.where(e, up + 1, lo)
    out.append(("random", lo.to(torch.int32), up.to(torch.int32), None))
    return out


def hold_frame_sum(c: DeviceColumn, layout, lo, up, what: str) -> None:
    """Counts and int64 sums bit for bit; f64 sums that are not finite bit
    for bit, finite ones within F64_RTOL_FRAME of the prefix's sum of |x|
    up to the frame's end."""
    got = WK.frame_sum_count(c.data, c.validity, layout.seg_start, lo, up)
    want = WK.frame_sum_count_plain(c.data, c.validity, layout.seg_start, lo,
                                    up)
    hold("frame_sum_count", [(got[1], want[1])], what)
    if c.data.dtype == torch.int64:
        hold("frame_sum_count", [(got[0], want[0])], what)
        return
    g, w = got[0], want[0]
    finite = torch.isfinite(w)
    require(torch.equal(bits(g[~finite]), bits(w[~finite])),
            f"frame_sum_count: {what}: a non-finite sum differs")
    x = torch.where(c.validity & torch.isfinite(c.data), c.data.abs(), 0.0)
    scale = torch.cumsum(x, 0)[up.long().clamp(min=0)] if c.num_rows \
        else x
    err = (g - w).abs().masked_fill(~finite, 0.0)
    require(bool((err <= F64_RTOL_FRAME * scale).all()),
            f"frame_sum_count differs from its plain version: {what}")
    ERRS["frame_sum_count"] = max(ERRS.get("frame_sum_count", 0.0),
                                  float(err.max()) if err.numel() else 0.0)


def hold_range_bounds(key: torch.Tensor, layout, pre, fol, what: str):
    hold("range_frame_bounds", list(zip(
        WK.range_frame_bounds(key, layout.seg_start, layout.seg_end, pre,
                              fol),
        WK.range_frame_bounds_plain(key, layout.seg_start, layout.seg_end,
                                    pre, fol))), what)


def hold_frame_extreme(c: DeviceColumn, lo, up, is_min: bool, max_len,
                       what: str) -> None:
    hold("frame_extreme", list(zip(
        WK.frame_extreme(c.data, c.validity, lo, up, is_min, max_len),
        WK.frame_extreme_plain(c.data, c.validity, lo, up, is_min,
                               max_len))), what)


def sorted_keys(rng, part: torch.Tensor, dtype, lo: int, hi: int):
    """A key ascending within each partition (ties included)."""
    seg = np.cumsum(part.cpu().numpy()) - 1
    key = rng.randint(lo, hi, len(seg), dtype=np.int64).astype(dtype)
    return key[np.lexsort((key, seg))]


def window_key_cases(rng, part: torch.Tensor, dev) -> dict:
    """int32 and int64 order keys: small with ties, at the types' ends
    (key - preceding and key + following wrap), and with each partition's
    first key 0, as a null order key sorts (the run is not sorted
    there)."""
    out = {}
    starts = np.flatnonzero(part.cpu().numpy())
    for dt in (np.int32, np.int64):
        info = np.iinfo(dt)
        small = sorted_keys(rng, part, dt, -40, 40)
        edges = sorted_keys(rng, part, dt, info.min, info.max)
        null_first = small.copy()
        null_first[starts] = 0
        for name, k in (("small", small), ("edges", edges),
                        ("null_first", null_first)):
            out[f"{dt.__name__} {name}"] = torch.from_numpy(k).to(dev)
    return out


def window_time_shape(rng, dev):
    """Phase 16's largest task partition (W1-W6): three keys' rows, each
    key a partition sorted by t (0-39: the peer runs), x DOUBLE and v
    LONG with n // 9 nulls; and the layout of it."""
    n = WINDOW_SHAPE_ROWS
    seg = np.repeat(np.arange(3), n // 3)
    t = np.sort(rng.randint(0, 40, n).reshape(3, -1), axis=1).reshape(-1)
    part = np.r_[True, seg[1:] != seg[:-1]]
    peer = part | np.r_[True, t[1:] != t[:-1]]
    layout = WK.window_layout(torch.from_numpy(part).to(dev),
                              torch.from_numpy(peer).to(dev))
    valid = np.ones(n, np.bool_)
    valid[rng.choice(n, n // 9, replace=False)] = False
    x = DeviceColumn.from_numpy(np.where(valid, rng.randn(n), 0.0), T.DOUBLE,
                                valid, dev)
    key = torch.from_numpy(t.astype(np.int32)).to(dev)
    return (torch.from_numpy(part).to(dev), torch.from_numpy(peer).to(dev),
            layout, x, key)


def check_window(rng, dev, summary) -> None:
    """window_layout, frame_sum_count, range_frame_bounds and
    frame_extreme against their plain versions at n = 0, 1 and 1,048,576
    over partitions of one row, of all rows and ~1,000 random ones with
    peer runs, and at 1,000,003 over the random ones (full-size extremes
    over every type on the random partitions, int64 and double on the
    others): layouts, counts, int64 sums, bounds and
    extremes bit for bit, f64 sums within 1e-12 of the prefix's sum of
    |x| (NaN and the infinities bit for bit); int64 values at the limits,
    floats with NaN, infinities and both zeros, 10% nulls; ROWS frames
    (clamped, empty, unbounded), the running and whole frames and random
    frames; RANGE frames over int32 and int64 keys with ties, at the
    types' ends and with a null key's zero first.  Then each timed at
    phase 16's shapes."""
    for n in (0, 1, N, RAGGED):
        # the ragged size over the random partitions only: the script's
        # time
        for shape in (("random",) if n == RAGGED else
                      ("one", "all", "random")):
            part, peer = window_flags(rng, n, shape, dev)
            what = f"n={n} {shape}"
            layout = hold_layout(part, peer, what)
            frames = window_frames(rng, layout)
            for dt in (T.LONG, T.DOUBLE):
                c = tail_column(rng, n, dt, dev)
                for name, lo, up, _ in frames:
                    hold_frame_sum(c, layout, lo, up, f"{what} {dt!r} {name}")
            for dt in (EXTREME_TYPES if n < N or shape == "random"
                       else (T.LONG, T.DOUBLE)):
                c = tail_column(rng, n, dt, dev)
                for name, lo, up, max_len in frames:
                    if name in EXTREME_SKIP:
                        continue
                    for is_min in (True, False):
                        hold_frame_extreme(c, lo, up, is_min, max_len,
                                           f"{what} {dt!r} {name} "
                                           f"{'min' if is_min else 'max'}")
            if n == 0:
                continue
            for kname, key in window_key_cases(rng, part, dev).items():
                for pre, fol in WINDOW_RANGE_FRAMES:
                    hold_range_bounds(key, layout, pre, fol,
                                      f"{what} {kname} {pre},{fol}")
    # timed at phase 16's shapes
    part, peer, layout, x, key = window_time_shape(rng, dev)
    n = WINDOW_SHAPE_ROWS
    lo7, up7 = WK.frame_bounds_rows(layout, 3, 3)          # W5's avg(x)
    hold_layout(part, peer, "phase 16's shape")
    hold_frame_sum(x, layout, lo7, up7, "phase 16's shape")
    hold_range_bounds(key, layout, 5, 5, "phase 16's shape")
    # frame_extreme: one key's partition, ROWS UNBOUNDED PRECEDING to
    # CURRENT ROW, which torch.cummin computes as one call
    m = WINDOW_KEY_ROWS
    v = tail_column(rng, m, T.LONG, dev, null_frac=1 / 9)
    run_lo = torch.zeros(m, dtype=torch.int32, device=dev)
    run_up = torch.arange(m, dtype=torch.int32, device=dev)
    masked = torch.where(v.validity, v.data, 2**63 - 1)
    hold_frame_extreme(v, run_lo, run_up, True, None, "phase 16's shape")
    hold("frame_extreme", [(WK.frame_extreme(
        v.data, v.validity, run_lo, run_up, True)[0],
        torch.cummin(masked, 0).values)], "against torch.cummin")
    steps = 2 * max(int(n // 3).bit_length(), 1)
    cases = {
        "window_layout": (
            lambda: WK.window_layout(part, peer),
            lambda: WK.window_layout_plain(part, peer), None, 22 * n, n,
            n, "held_w1_task"),
        "frame_sum_count": (
            lambda: WK.frame_sum_count(x.data, x.validity, layout.seg_start,
                                       lo7, up7),
            lambda: WK.frame_sum_count_plain(x.data, x.validity,
                                             layout.seg_start, lo7, up7),
            None, 37 * n, 20 * n, n, "held_w5_avg_x_task"),
        "range_frame_bounds": (
            lambda: WK.range_frame_bounds(key, layout.seg_start,
                                          layout.seg_end, 5, 5),
            lambda: WK.range_frame_bounds_plain(key, layout.seg_start,
                                                layout.seg_end, 5, 5),
            None, 20 * n, steps * n, n, "held_w6_range_task"),
        "frame_extreme": (
            lambda: WK.frame_extreme(v.data, v.validity, run_lo, run_up,
                                     True),
            lambda: WK.frame_extreme_plain(v.data, v.validity, run_lo,
                                           run_up, True),
            lambda: torch.cummin(torch.where(v.validity, v.data,
                                             2**63 - 1), 0),
            26 * m, WK.extreme_levels(m) * m, m, "held_key_running_min"),
    }
    for kernel, (fn, plain, library, nbytes, ops, rows, shape) in \
            cases.items():
        line = {"kernel": kernel, "shape": shape, "n": rows,
                **measure(fn, plain, library, nbytes, ops)}
        emit(line)
        summary[kernel] = summarize(line, nbytes, ops)


def phase_kernels(dev, tables) -> dict:
    # the profiler itself must see the card
    device_profile(lambda: torch.ones(8, device=dev) + 1)
    rng = np.random.RandomState(2024)
    summary = {}
    shapes = q1_shapes(dev)
    masks = check_compaction(rng, dev, shapes, summary)
    check_gather(rng, dev, masks, shapes, summary)
    check_masked_sum(rng, dev, masks, summary)
    check_concat(rng, dev, summary)
    check_murmur3(rng, dev, shapes, summary)
    check_partition(rng, dev, shapes, summary)
    check_sort(rng, dev, shapes, summary)
    check_segmented_sum(rng, dev, shapes, summary)
    q3 = q3_shapes(dev, tables)
    check_string_gather(rng, dev, q3, summary)
    check_string_concat(rng, dev, q3, summary)
    check_hash_string(rng, dev, q3, summary)
    check_string_sort(rng, dev, q3, summary)
    check_string_rows_equal(rng, dev, q3, summary)
    check_join(rng, dev, q3, summary)
    check_multi_join(rng, dev, summary)
    check_conditional_join(rng, dev, summary)
    check_left_join(rng, dev, summary)
    check_left_multi_join(rng, dev, summary)
    check_null_extend(rng, dev, summary)
    check_semi_join(rng, dev, tables, summary)
    check_substring(rng, dev)
    check_fused(rng, dev, summary)
    check_agg_tail(rng, dev, summary)
    check_picks(rng, dev, summary)
    check_decimal128(rng, dev, summary)
    check_window(rng, dev, summary)
    torch.cuda.synchronize()
    return summary


# -- phase 4 ------------------------------------------------------------------

def q6_numpy(chunk) -> tuple:
    """Independent q6 over host arrays: (sum of (price/100)*(disc/100), n)."""
    ship = chunk["l_shipdate"]
    disc = chunk["l_discount"]
    mask = ((ship >= tpch._days(1994, 1, 1)) & (ship < tpch._days(1995, 1, 1))
            & (disc >= 5) & (disc <= 7) & (chunk["l_quantity"] < 2400))
    price = chunk["l_extendedprice"][mask].astype(np.float64) / 100
    return float(np.sum(price * (disc[mask].astype(np.float64) / 100))), \
        int(mask.sum())


def q1_numpy(chunk) -> np.ndarray:
    """Independent q1 partial over host arrays: [8 keys, 6] sums of qty,
    price, disc_price, charge, disc and the row count (key 0 unused)."""
    mask = chunk["l_shipdate"] <= Q1_CUTOFF
    key = chunk["l_linenumber"][mask]
    qty, price, disc, tax = (chunk[c][mask].astype(np.float64) / 100 for c in
                             ("l_quantity", "l_extendedprice", "l_discount",
                              "l_tax"))
    disc_price = price * (1.0 - disc)
    charge = disc_price * (1.0 + tax)
    cols = [np.bincount(key, w, minlength=8)
            for w in (qty, price, disc_price, charge, disc)]
    return np.stack(cols + [np.bincount(key, minlength=8).astype(
        np.float64)], axis=1)


def q1_rows_numpy(acc: np.ndarray) -> list:
    """(key, sum_qty, sum_base_price, sum_disc_price, sum_charge, avg_qty,
    avg_price, avg_disc, count_order) for keys 1..7."""
    rows = []
    for k in range(1, 8):
        sq, sp, sdp, sc, sd, n = acc[k]
        rows.append((k, sq, sp, sdp, sc, sq / n, sp / n, sd / n, int(n)))
    return rows


def phase_data(dev):
    t0 = time.perf_counter()
    batches, revenue, count = [], 0.0, 0
    q1_acc = np.zeros((8, 6))
    q1d_acc = np.zeros((8, 6), np.int64)
    for chunk in tpch.iter_lineitem(SF10_ROWS, seed=42, batch_rows=N):
        r, c = q6_numpy(chunk)
        revenue += r
        count += c
        q1_acc += q1_numpy(chunk)
        q1d_acc += q1_decimal_numpy(chunk)
        batches.append(batch_from_numpy(chunk, tpch.LINEITEM_SCHEMA, dev))
    torch.cuda.synchronize()
    resident = sum(c.data.nbytes + c.validity.nbytes
                   for b in batches for c in b.columns)
    emit({"phase": "data", "rows": SF10_ROWS, "batches": len(batches),
          "resident_bytes": resident,
          "setup_seconds": time.perf_counter() - t0,
          "numpy_q6_revenue": revenue, "numpy_q6_count": count})
    dfs = {}
    for name, conf in (("fused", None), ("unfused", FUSE_OFF)):
        sess = GpuSession(conf)
        require(sess.device.type == "cuda", "session is not on the card")
        require(sess.conf.shuffle_partitions == SHUFFLE_PARTITIONS,
                "q1 runs with spark.sql.shuffle.partitions = 16")
        require(sess.conf.fuse_stages == (conf is None),
                "spark.rapids.sql.tpu.fuseStages is on by default")
        dfs[name] = sess.create_dataframe(batches, num_partitions=4)
    return (dfs, (revenue, count), q1_rows_numpy(q1_acc),
            q1_decimal_rows_numpy(q1d_acc), len(batches))


def run_path(name: str, query, df, kernels) -> tuple:
    """The main path of one query: every launch count set to 0 just before
    it runs and read just after; each of ``kernels`` must have launched."""
    _lib.reset_launch_counts()
    rows = query(df).collect()
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    emit({"phase": f"{name}_launches", "launches": launches})
    for k in kernels:
        require(launches.get(k, 0) > 0, f"{name} never launched {k}")
    return rows, launches


def run_phase_path(name: str, query, kernels) -> tuple:
    """The main path of one query, traced by torch.profiler: the counts
    set to 0 just before, read just after; each of ``kernels`` must have
    launched.  Returns the rows, the plan, the launches, the run's wall
    (the trace's cost in it) and its device profile for ``time_path``
    (None where the trace saw no device activity)."""
    _lib.reset_launch_counts()
    t = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        df = query(None)
        plan = df.physical_plan()
        rows = GpuEngine().collect(plan)
        torch.cuda.synchronize()
    first_wall = time.perf_counter() - t
    launches = dict(_lib.LAUNCHES)
    emit({"phase": f"{name}_launches", "launches": launches})
    for k in kernels:
        require(launches.get(k, 0) > 0, f"{name} never launched {k}")
    events = device_events(prof)
    by_name: dict = {}
    for event, ms in events:
        by_name[event] = by_name.get(event, 0.0) + ms
    profile = (sum(by_name.values()), len(events), by_name) if events \
        else None
    return rows, plan, launches, first_wall, profile


def time_path(name: str, query, df, rows: int = SF10_ROWS,
              profile=None, runs: int = 3) -> dict:
    """Median wall of ``runs`` runs after the main-path run, then one
    profiled
    run (``profile``: the (busy ms, activities, ms by name) of the
    main-path run instead, traced already): the card's busy time, its
    activities and idle share; ``rows`` scanned per run; the peak memory
    the runs allocate above what was resident before."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for _ in range(runs):
        t = time.perf_counter()
        query(df).collect()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    busy_ms, activities, by_name = profile or device_profile(
        lambda: query(df).collect(), calls=1, warm=False)
    if activities is None:   # no trace saw the card: busy time unknown
        busy_ms = idle = None
    else:
        idle = 1.0 - busy_ms / (wall * 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": f"{name}_profile", "device_busy_ms": busy_ms,
          "device_activities": activities, "idle_share": idle,
          "top_device_ms": top})
    return {"wall_s": wall, "wall_s_runs": walls,
            "rows_per_s": rows / wall, "device_busy_ms": busy_ms,
            "device_activities": activities, "idle_share": idle,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "resident_bytes": resident,
            "peak_above_resident_bytes":
                torch.cuda.max_memory_allocated() - resident}


def per_batch(timing: dict, nbatches: int):
    """Device activities a batch (None where no trace saw the card)."""
    activities = timing["device_activities"]
    return None if activities is None else activities / nbatches


def check_fusion(name: str, query, df, launches, fused: bool,
                 nbatches: int) -> dict:
    """Fused, the plan holds a segment and its kernel ran once a batch, and
    the filter's compaction never ran (q6's gather neither); unfused,
    neither the segment nor its kernel.  Launches and device activities
    per batch beside."""
    plan = query(df).explain()
    require(("GpuFusedSegment" in plan) == fused,
            f"{name}: the plan's segments: {plan}")
    fk = launches.get("fused_segment", 0)
    if fused:
        require(fk == nbatches, f"{name}: fused_segment launched {fk} "
                f"times over {nbatches} batches")
        if name == "q6":
            require(not launches.get("compaction_map")
                    and not launches.get("gather"),
                    f"q6 fused still compacts: {launches}")
    else:
        require(fk == 0, f"{name}: fused_segment launched unfused")
    return {"fused": fused,
            "launches_per_batch": sum(launches.values()) / nbatches}


def phase_q6(dfs, ref, nbatches) -> dict:
    revenue, count = ref
    by_path = {}
    for fused, kernels in ((True, Q6_KERNELS), (False, Q6_UNFUSED_KERNELS)):
        name = "q6" if fused else "q6_unfused"
        df = dfs["fused" if fused else "unfused"]
        rows, launches = run_path(name, tpch.q6, df, kernels)
        fusion = check_fusion("q6", tpch.q6, df, launches, fused, nbatches)
        require(len(rows) == 1 and rows[0][0] is not None, f"q6 gave {rows}")
        rel = abs(rows[0][0] - revenue) / abs(revenue)
        require(rel <= F64_RTOL_Q6,
                f"{name} revenue {rows[0][0]} vs numpy {revenue}")
        timing = time_path(name, tpch.q6, df)
        rows_c = tpch.q6_count(df).collect()
        require(rows_c[0][1] == count,
                f"{name} count {rows_c[0][1]} vs numpy {count}")
        rel_c = abs(rows_c[0][0] - revenue) / abs(revenue)
        require(rel_c <= F64_RTOL_Q6, f"{name} q6_count revenue {rows_c[0][0]}")
        emit({"phase": name, "rows": SF10_ROWS, "revenue": rows[0][0],
              "rel_err": rel, "count": rows_c[0][1], **fusion,
              "activities_per_batch": per_batch(timing, nbatches),
              **timing})
        by_path[name] = launches
    return by_path


def phase_q1(dfs, ref_rows, nbatches) -> dict:
    by_path = {}
    for fused, kernels in ((True, Q1_KERNELS), (False, Q1_UNFUSED_KERNELS)):
        name = "q1" if fused else "q1_unfused"
        df = dfs["fused" if fused else "unfused"]
        rows, launches = run_path(name, tpch.q1, df, kernels)
        fusion = check_fusion("q1", tpch.q1, df, launches, fused, nbatches)
        rows = sorted(rows, key=lambda r: (r[0] is not None, r[0]))
        require(len(rows) == 7 and [r[0] for r in rows] == list(range(1, 8)),
                f"{name} gave keys {[r[0] for r in rows]}")
        max_rel = 0.0
        for got, want in zip(rows, ref_rows):
            require(got[8] == want[8], f"q1 count {got[8]} vs numpy {want[8]}")
            for g, w in zip(got[1:8], want[1:8]):
                require(g is not None and np.isfinite(g), f"q1 gave {got}")
                max_rel = max(max_rel, abs(g - w) / abs(w))
        require(max_rel <= F64_RTOL_Q1,
                f"{name} off numpy by {max_rel} relative")
        timing = time_path(name, tpch.q1, df)
        emit({"phase": name, "rows": SF10_ROWS, "groups": len(rows),
              "max_rel_err": max_rel, "count_order": [r[8] for r in rows],
              "shuffle_partitions": SHUFFLE_PARTITIONS, **fusion,
              "activities_per_batch": per_batch(timing, nbatches),
              **timing})
        by_path[name] = launches
    return by_path


# -- phase 14 ----------------------------------------------------------------

#: the kernels q1_decimal's main path must launch
Q1D_KERNELS = ("decimal128_binary", "decimal128_divide", "segmented_sum128",
               "gather", "sort", "concat", "murmur3", "partition")


def q1_decimal_numpy(chunk) -> np.ndarray:
    """Exact q1_decimal partial over host arrays: int64 [8 keys, 6] sums
    of qty, price, disc_price (scale 4), charge (scale 6), disc, and the
    row count (key 0 unused).  disc_price = price * (100 - disc) and
    charge = disc_price * (100 + tax) in unscaled int64; the largest
    group sum, charge's, stays below 2**63 at SF10."""
    mask = chunk["l_shipdate"] <= Q1_CUTOFF
    key = chunk["l_linenumber"][mask]
    qty, price, disc, tax = (chunk[c][mask] for c in (
        "l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    disc_price = price * (100 - disc)
    charge = disc_price * (100 + tax)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    out = np.zeros((8, 6), np.int64)
    for j, x in enumerate((qty, price, disc_price, charge, disc)):
        out[ks[starts], j] = np.add.reduceat(x[order], starts)
    out[ks[starts], 5] = np.diff(np.r_[starts, len(ks)])
    return out


def half_up_div(num: int, den: int) -> int:
    q, r = divmod(abs(num), den)
    q += 1 if 2 * r >= den else 0
    return -q if num < 0 else q


def q1_decimal_rows_numpy(acc: np.ndarray) -> list:
    """(key, sum_qty, sum_base_price, sum_disc_price, sum_charge, avg_qty,
    avg_price, avg_disc, count_order) as unscaled ints, keys 1..7; an
    average is HALF_UP of sum * 10**4 / count (scale 2 -> 6)."""
    rows = []
    for k in range(1, 8):
        sq, sp, sdp, sc, sd, n = (int(v) for v in acc[k])
        rows.append((k, sq, sp, sdp, sc, half_up_div(sq * 10**4, n),
                     half_up_div(sp * 10**4, n), half_up_div(sd * 10**4, n),
                     n))
    return rows


def unscaled(v):
    """A row's decimal.Decimal as its unscaled int (its digits, exactly);
    any other value as it is."""
    if isinstance(v, decimal.Decimal):
        sign, digits, _ = v.as_tuple()
        n = int("".join(map(str, digits)))
        return -n if sign else n
    return v


def phase_q1_decimal(dfs, ref_rows, nbatches) -> dict:
    """q1_decimal over phase 5's lineitem (fused session: its partial
    aggregate holds SUM128 buffers and runs op by op), every value exact
    against numpy's integers, then timed."""
    df = dfs["fused"]
    rows, launches = run_path("q1_decimal", tpch.q1_decimal, df, Q1D_KERNELS)
    rows = sorted(([unscaled(v) for v in r] for r in rows),
                  key=lambda r: (r[0] is not None, r[0]))
    require([tuple(r) for r in rows] == ref_rows,
            f"q1_decimal gave {rows} where numpy has {ref_rows}")
    timing = time_path("q1_decimal", tpch.q1_decimal, df)
    emit({"phase": "q1_decimal", "rows": SF10_ROWS, "groups": len(rows),
          "exact": True, "count_order": [r[8] for r in rows],
          "sum_charge": [str(r[4]) for r in rows],
          "shuffle_partitions": SHUFFLE_PARTITIONS,
          "activities_per_batch": per_batch(timing, nbatches), **timing})
    return {"q1_decimal": launches}


# -- phase 7 ------------------------------------------------------------------

class Q3Numpy:
    """Independent q3 over host arrays: the joins as lookups into the
    dimension arrays, the groups by (d_year, i_brand_id, i_brand), the sums
    in integer cents (ss_ext_sales_price has two decimals), so that the
    order, ties included, is exact."""

    def __init__(self, d, i):
        self.moy, self.year = d["d_moy"], d["d_year"]
        keep = i["i_manufact_id"] == 28
        pairs = sorted({(int(b), s) for b, s in
                        zip(i["i_brand_id"][keep], i["i_brand"][keep])})
        index = {p: g for g, p in enumerate(pairs)}
        self.pairs = pairs
        self.item_group = np.full(len(keep), -1, np.int64)
        for k in np.flatnonzero(keep):
            self.item_group[k] = index[(int(i["i_brand_id"][k]),
                                        i["i_brand"][k])]
        self.years = np.unique(self.year)
        self.cents = np.zeros(len(self.years) * len(pairs), np.int64)
        self.rows = np.zeros_like(self.cents)

    def add(self, data) -> None:
        ds = data["ss_sold_date_sk"] - 2450000
        g = self.item_group[data["ss_item_sk"] - 1]
        ok = (self.moy[ds] == 11) & (g >= 0)
        yi = np.searchsorted(self.years, self.year[ds[ok]])
        gid = yi * len(self.pairs) + g[ok]
        cents = np.rint(data["ss_ext_sales_price"][ok] * 100).astype(np.int64)
        size = len(self.cents)
        self.cents += np.bincount(gid, cents, minlength=size).astype(np.int64)
        self.rows += np.bincount(gid, minlength=size)

    def result(self) -> list:
        """(d_year, i_brand_id, i_brand, cents) in q3's order."""
        out = []
        for gid in np.flatnonzero(self.rows):
            y, p = divmod(int(gid), len(self.pairs))
            out.append((int(self.years[y]), *self.pairs[p],
                        int(self.cents[gid])))
        return sorted(out, key=lambda r: (r[0], -r[3], r[1]))


def phase_q3_data(dev, tables, q25_ref, gauntlet):
    """store_sales on the card and q3's numpy result; on the way, the pool
    store_returns draws from, q25's store_sales rows (``q25_ref``) and
    phase 11's (``gauntlet``)."""
    date, item, d, i = tables
    t0 = time.perf_counter()
    ref = Q3Numpy(d, i)
    batches, pool_chunks = [], []
    for data, validity in tpcds.iter_store_sales(SS_ROWS, ITEM_ROWS,
                                                 batch_rows=N):
        ref.add(data)
        q25_ref.add_store_sales(data)
        gauntlet.add_store_sales(data, validity)
        pool_chunks.append(({n: data[n] for n in SS_POOL}, validity))
        batches.append(tpcds.store_sales_batch(data, validity, dev))
    date_dev, item_dev = to_device(date, dev), to_device(item, dev)
    torch.cuda.synchronize()
    resident = sum(t.nbytes for b in batches for c in b.columns
                   for t in (c.data, c.validity))
    emit({"phase": "q3_data", "store_sales_rows": SS_ROWS,
          "batches": len(batches), "resident_bytes": resident,
          "item_rows": item_dev.num_rows, "date_dim_rows": date_dev.num_rows,
          "setup_seconds": time.perf_counter() - t0,
          "numpy_q3_groups": int((ref.rows > 0).sum())})
    sess = GpuSession()
    dfs = (sess.create_dataframe(batches, num_partitions=4),
           sess.create_dataframe([date_dev]),
           sess.create_dataframe([item_dev]))
    return dfs, ref.result(), tpcds.host_pool(pool_chunks, SS_POOL)


def check_q3_rows(rows, want) -> float:
    """The same groups as numpy, sums within F64_RTOL_Q3, in q3's order;
    two groups may trade places only where numpy's sums tie to the cent."""
    require(len(rows) == len(want), f"q3 gave {len(rows)} groups, numpy "
            f"{len(want)}")
    max_rel = 0.0
    by_key = {w[:3]: w[3] for w in want}
    for r in rows:
        require(r[:3] in by_key, f"q3 gave a group numpy has not: {r}")
        w = by_key[r[:3]] / 100
        max_rel = max(max_rel, abs(r[3] - w) / abs(w))
    require(max_rel <= F64_RTOL_Q3, f"q3 off numpy by {max_rel} relative")
    for a, b in zip(rows, rows[1:]):
        require((a[0], -a[3], a[1]) <= (b[0], -b[3], b[1]),
                f"q3 rows out of order: {a} before {b}")
    for g, w in zip(rows, want):
        require(g[:3] == w[:3] or by_key[g[:3]] == w[3],
                f"q3 order differs from numpy's: {g} where numpy has {w}")
    return max_rel


def phase_q3(dfs, want) -> dict:
    query = lambda _: tpcds.q3(*dfs)  # noqa: E731
    rows, launches = run_path("q3", query, None, Q3_KERNELS)
    max_rel = check_q3_rows(rows, want)
    ties = sum(a[0] == b[0] and a[3] == b[3] for a, b in zip(want, want[1:]))
    timing = time_path("q3", query, None, SS_ROWS)
    emit({"phase": "q3", "rows": SS_ROWS, "groups": len(rows),
          "max_rel_err": max_rel, "numpy_sum_ties": ties,
          "first_rows": rows[:3], **timing})
    return launches


# -- phase 8 ------------------------------------------------------------------

def cents(x: np.ndarray) -> np.ndarray:
    return np.rint(x * 100).astype(np.int64)


class Q25Numpy:
    """Independent q25 and q17 over host arrays.  Each fact keeps only the
    rows in its query's date window (the inner joins commute with those
    filters); the composite keys pack into int64 ((ticket, item) and
    (customer, item), all within int32) and join by sort and
    searchsorted; every store_sales store and item exists.  q25: (item,
    store) decides its four group keys, so the groups are (item, store)
    and sort by them; the sums are integer cents.  q17: the groups are
    (item, store name), in the order of the item (its id and description
    sort as its key) and the name; the standard deviations two-pass in
    float64."""

    # query -> (year, store_sales months, the later facts' months)
    WINDOWS = {"q25": (2000, (4, 4), (4, 10)), "q17": (2001, (1, 3), (1, 9))}
    SS_COLS = ("ss_ticket_number", "ss_item_sk", "ss_store_sk",
               "ss_net_profit", "ss_quantity")
    SR_COLS = ("sr_ticket_number", "sr_item_sk", "sr_customer_sk",
               "sr_net_loss", "sr_return_quantity")
    CS_COLS = ("cs_bill_customer_sk", "cs_item_sk", "cs_net_profit",
               "cs_quantity")

    def __init__(self, d):
        self.year, self.moy = d["d_year"], d["d_moy"]
        self.parts = {q: ([], [], []) for q in self.WINDOWS}

    def window(self, date_sk, year: int, months) -> np.ndarray:
        i = date_sk.astype(np.int64) - 2450000
        ok = (i >= 0) & (i < len(self.year))
        j = np.where(ok, i, 0)
        return ok & (self.year[j] == year) & (self.moy[j] >= months[0]) & \
            (self.moy[j] <= months[1])

    def _add(self, fact: int, data, date_col: str, cols) -> None:
        for q, (year, first, later) in self.WINDOWS.items():
            ok = self.window(data[date_col], year, later if fact else first)
            self.parts[q][fact].append({k: data[k][ok] for k in cols})

    def add_store_sales(self, data) -> None:
        self._add(0, data, "ss_sold_date_sk", self.SS_COLS)

    def add_store_returns(self, data) -> None:
        self._add(1, data, "sr_returned_date_sk", self.SR_COLS)

    def add_catalog_sales(self, data) -> None:
        self._add(2, data, "cs_sold_date_sk", self.CS_COLS)

    @staticmethod
    def _cat(parts):
        return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    @staticmethod
    def _pack(a, b) -> np.ndarray:
        return (a.astype(np.int64) << 32) | b.astype(np.int64)

    @staticmethod
    def _join(probe: np.ndarray, build: np.ndarray):
        """(probe row, build row) of every equal pair."""
        order = np.argsort(build, kind="stable")
        keys = build[order]
        lo = np.searchsorted(keys, probe, "left")
        cnt = np.searchsorted(keys, probe, "right") - lo
        li = np.repeat(np.arange(len(probe)), cnt)
        start = np.repeat(np.cumsum(cnt) - cnt, cnt)
        return li, order[lo[li] + np.arange(len(li)) - start]

    def chain(self, q: str):
        """The three facts of query q and the rows of each that the chain
        joins: (ss, sr, cs, a, b, c), row i of the join is (a[i], b[i],
        c[i])."""
        ss, sr, cs = (self._cat(x) for x in self.parts[q])
        a, b = self._join(self._pack(ss["ss_ticket_number"], ss["ss_item_sk"]),
                          self._pack(sr["sr_ticket_number"], sr["sr_item_sk"]))
        b2, c = self._join(self._pack(sr["sr_customer_sk"][b],
                                      sr["sr_item_sk"][b]),
                           self._pack(cs["cs_bill_customer_sk"],
                                      cs["cs_item_sk"]))
        return ss, sr, cs, a[b2], b[b2], c

    def result(self, limit: int = 100):
        """((item, store, ss cents, sr cents, cs cents) of the first
        ``limit`` groups in q25's order, the number of groups)."""
        ss, sr, cs, a, b, c = self.chain("q25")
        group = self._pack(ss["ss_item_sk"][a], ss["ss_store_sk"][a])
        keys, inv = np.unique(group, return_inverse=True)
        sums = [np.bincount(inv, cents(v), len(keys)).astype(np.int64)
                for v in (ss["ss_net_profit"][a], sr["sr_net_loss"][b],
                          cs["cs_net_profit"][c])]
        rows = [(int(k >> 32), int(k & 0xFFFFFFFF), *map(int, t))
                for k, t in zip(keys[:limit], zip(*(x[:limit]
                                                    for x in sums)))]
        return rows, len(keys)

    def q17(self, store_names) -> list:
        """Every q17 group in q17's order: (item, store name), then for
        each of the three quantities its count, mean, sample standard
        deviation and that over the mean (None below two rows)."""
        ss, sr, cs, a, b, c = self.chain("q17")
        names = sorted(set(store_names))
        rank = np.array([names.index(x) for x in store_names])
        group = (ss["ss_item_sk"][a].astype(np.int64) << 8) | \
            rank[ss["ss_store_sk"][a] - 1]
        keys, inv = np.unique(group, return_inverse=True)
        count = np.bincount(inv, minlength=len(keys))
        stats = []
        for q in (ss["ss_quantity"][a], sr["sr_return_quantity"][b],
                  cs["cs_quantity"][c]):
            q = q.astype(np.float64)
            mean = np.bincount(inv, q, len(keys)) / count
            m2 = np.bincount(inv, (q - mean[inv]) ** 2, len(keys))
            with np.errstate(all="ignore"):
                std = np.sqrt(m2 / (count - 1))
            stats.append((mean, std))
        rows = []
        for gi, k in enumerate(keys.tolist()):
            row = [k >> 8, names[k & 0xFF]]
            n = int(count[gi])
            for mean, std in stats:
                sd = float(std[gi]) if n > 1 else None
                row += [n, float(mean[gi]), sd,
                        sd / float(mean[gi]) if n > 1 else None]
            rows.append(tuple(row))
        return rows


def phase_q25_data(dev, q3_dfs, ss_pool, ref: "Q25Numpy", tables,
                   q72_ref: "Q72Numpy", gauntlet: "GauntletNumpy"):
    """store_returns and catalog_sales on the card, drawn from the pools;
    the dataframes of q25; the numpy result; on the way, q72's and phase
    11's sales (``q72_ref``, ``gauntlet``) and the (item, order) pool
    catalog_returns draws from, with the catalog_sales batches q72
    reuses."""
    t0 = time.perf_counter()
    sr_batches, sr_chunks = [], []
    for data, validity in tpcds.iter_store_returns(
            SR_ROWS, ITEM_ROWS, pool=ss_pool, match_frac=0.9, batch_rows=N):
        ref.add_store_returns(data)
        sr_chunks.append(({n: data[n] for n in SR_POOL}, validity))
        sr_batches.append(tpcds.fact_batch(data, validity,
                                           tpcds.STORE_RETURNS_SCHEMA, dev))
    sr_pool = tpcds.host_pool(sr_chunks, SR_POOL)
    cs_batches, order_chunks = [], []
    for data, validity in tpcds.iter_catalog_sales(
            CS_ROWS, ITEM_ROWS, pair_pool=sr_pool, match_frac=0.7,
            batch_rows=N):
        ref.add_catalog_sales(data)
        q72_ref.add_catalog_sales(data, validity)
        gauntlet.add_catalog_sales(data, validity)
        order_chunks.append(({n: data[n] for n in CS_ORDER_POOL}, {}))
        cs_batches.append(tpcds.fact_batch(data, validity,
                                           tpcds.CATALOG_SALES_SCHEMA, dev))
    store = tpcds.gen_store(dev)
    torch.cuda.synchronize()
    want, groups = ref.result()
    resident = sum(t.nbytes for b in sr_batches + cs_batches
                   for c in b.columns for t in (c.data, c.validity))
    emit({"phase": "q25_data", "store_returns_rows": SR_ROWS,
          "catalog_sales_rows": CS_ROWS, "store_rows": store.num_rows,
          "resident_bytes_added": resident, "numpy_q25_groups": groups,
          "setup_seconds": time.perf_counter() - t0})
    ss_df, dd_df, item_df = q3_dfs
    sess = ss_df.session
    dfs = (ss_df, sess.create_dataframe(sr_batches, num_partitions=4),
           sess.create_dataframe(cs_batches, num_partitions=4), dd_df,
           sess.create_dataframe([store]), item_df)
    _, item, _, _ = tables
    names = {"item_id": item.column("i_item_id").to_pylist(),
             "item_desc": item.column("i_item_desc").to_pylist(),
             "store": list(zip(store.column("s_store_id").to_pylist(),
                               store.column("s_store_name").to_pylist()))}
    q17_want = [(names["item_id"][it - 1], names["item_desc"][it - 1],
                 *rest) for it, *rest in ref.q17(
                     [name for _, name in names["store"]])]
    emit({"phase": "q17_numpy", "groups": len(q17_want),
          "groups_with_stddev": sum(r[5] is not None for r in q17_want)})
    return dfs, [(names["item_id"][it - 1], names["item_desc"][it - 1],
                  *names["store"][st - 1], s1, s2, s3)
                 for it, st, s1, s2, s3 in want], q17_want, cs_batches, \
        tpcds.host_pool(order_chunks, CS_ORDER_POOL)


def plan_nodes(node, seen=None):
    """Every exec of a tree once, with the exec each adaptive join built."""
    seen = set() if seen is None else seen
    if id(node) in seen:
        return
    seen.add(id(node))
    yield node
    kids = list(node.children)
    if isinstance(node, GpuAdaptiveJoinExec) and node.inner is not None:
        kids.append(node.inner)
    for k in kids:
        yield from plan_nodes(k, seen)


def check_q25_plan(plan) -> dict:
    """The adaptive store_sales x store_returns join went shuffled; every
    shuffled join took the streamed probe; the largest build partition and
    the coalesced groups of each shuffled join."""
    nodes = list(plan_nodes(plan))
    decisions = {}
    for n in nodes:
        if isinstance(n, GpuAdaptiveJoinExec):
            names = n.children[1].schema.names
            decisions[names[0]] = n.chosen
    require(any(k.startswith("sr_") and v == "shuffled"
                for k, v in decisions.items()),
            f"the store_returns join did not go shuffled: {decisions}")
    joins = []
    for n in nodes:
        if not isinstance(n, GpuShuffledHashJoinExec):
            continue
        reader = n.children[1]
        groups = (reader.spec._groups
                  if isinstance(reader, GpuCoalescedShuffleReaderExec)
                  else None)
        joins.append({"build": n.children[1].schema.names[0],
                      "largest_build_rows": n.largest_build_rows,
                      "target_rows": n.target_rows,
                      "branches": dict(n.branches), "groups": groups})
        require(set(n.branches) == {"streamed"},
                f"a shuffled join left the streamed probe: {joins[-1]}")
    require(len(joins) == 2, f"q25 ran {len(joins)} shuffled joins, not 2")
    return {"adaptive": decisions, "shuffled_joins": joins}


def check_q25_rows(rows, want) -> float:
    require(len(rows) == len(want) == 100,
            f"q25 gave {len(rows)} rows, numpy {len(want)}")
    max_rel = 0.0
    for g, w in zip(rows, want):
        require(g[:4] == w[:4], f"q25 row {g[:4]} where numpy has {w[:4]}")
        for got, c in zip(g[4:], w[4:]):
            require(got is not None and np.isfinite(got), f"q25 gave {g}")
            err = abs(got - c / 100)
            max_rel = max(max_rel, err / abs(c / 100) if c else err)
    require(max_rel <= F64_RTOL_Q25, f"q25 off numpy by {max_rel} relative")
    return max_rel


def phase_q25(dfs, want) -> dict:
    query = lambda _: tpcds.q25(*dfs)  # noqa: E731
    _lib.reset_launch_counts()
    plan = query(None).physical_plan()
    rows = GpuEngine().collect(plan)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    emit({"phase": "q25_launches", "launches": launches})
    for k in Q25_KERNELS:
        require(launches.get(k, 0) > 0, f"q25 never launched {k}")
    shape = check_q25_plan(plan)
    emit({"phase": "q25_plan", **shape})
    max_rel = check_q25_rows(rows, want)
    scanned = SS_ROWS + SR_ROWS + CS_ROWS
    timing = time_path("q25", query, None, scanned)
    emit({"phase": "q25", "fact_rows": scanned, "rows": len(rows),
          "max_rel_err": max_rel, "first_rows": rows[:3], **timing})
    return launches


F64_RTOL_Q17 = 1e-9             # against numpy's two-pass float64
Q17_KERNELS = Q25_KERNELS + ("segmented_m2",)


def check_q17_rows(name: str, rows, want) -> float:
    """numpy's groups in q17's order: keys and counts exact, the means,
    standard deviations and their ratios within F64_RTOL_Q17, null exactly
    where a group has fewer than two rows."""
    require(len(rows) == len(want),
            f"{name} gave {len(rows)} rows, numpy {len(want)}")
    max_rel = 0.0
    for g, w in zip(rows, want):
        require(g[:3] == w[:3], f"{name} row {g[:3]} where numpy has {w[:3]}")
        for f in range(3):
            got = g[3 + 4 * f: 7 + 4 * f]
            exp = w[3 + 4 * f: 7 + 4 * f]
            require(got[0] == exp[0], f"{name} count {got} vs numpy {exp}")
            for a, b in zip(got[1:], exp[1:]):
                require((a is None) == (b is None),
                        f"{name} nulls {got} vs numpy {exp}")
                if b is None:
                    continue
                require(np.isfinite(a), f"{name} gave {g}")
                err = abs(a - b)
                max_rel = max(max_rel, err / abs(b) if b else err)
    require(max_rel <= F64_RTOL_Q17, f"{name} off numpy by {max_rel} relative")
    return max_rel


def phase_q17(dfs, want) -> dict:
    """q17 on q25's tables and session: the main path (LIMIT 100) with its
    launches, then every group (no LIMIT), each against numpy; timed and
    profiled."""
    query = lambda _: tpcds.q17(*dfs)  # noqa: E731
    rows, launches = run_path("q17", query, None, Q17_KERNELS)
    max_rel = check_q17_rows("q17", rows, want[:100])
    every = tpcds.q17(*dfs, limit=None).collect()
    max_rel_all = check_q17_rows("q17 without LIMIT", every, want)
    timing = time_path("q17", query, None, SS_ROWS + SR_ROWS + CS_ROWS)
    emit({"phase": "q17", "rows": len(rows), "groups": len(every),
          "groups_with_stddev": sum(r[5] is not None for r in every),
          "max_rel_err": max_rel, "max_rel_err_every_group": max_rel_all,
          "first_rows": rows[:2], **timing})
    return launches


def phase_fusion_ab(dfs, q3_dfs, q25_dfs) -> None:
    """Fused against ``fuseStages=false`` on this card, in turns: AB_PAIRS
    pairs of each of q6, q1, q3 and q25 (wall of ``collect()``, planning
    included), the side that runs first alternating; the medians, the
    quartiles and the pairs the fused side won."""
    off = GpuSession(FUSE_OFF)
    q3_off = tuple(DataFrame(d.plan, off) for d in q3_dfs)
    q25_off = tuple(DataFrame(d.plan, off) for d in q25_dfs)
    cases = {"q6": (lambda: tpch.q6(dfs["fused"]),
                    lambda: tpch.q6(dfs["unfused"])),
             "q1": (lambda: tpch.q1(dfs["fused"]),
                    lambda: tpch.q1(dfs["unfused"])),
             "q3": (lambda: tpcds.q3(*q3_dfs), lambda: tpcds.q3(*q3_off)),
             "q25": (lambda: tpcds.q25(*q25_dfs),
                     lambda: tpcds.q25(*q25_off))}
    for name, sides in cases.items():
        for side in sides:
            side().collect()
        runs = ([], [])
        for i in range(AB_PAIRS):
            for k in ((0, 1) if i % 2 == 0 else (1, 0)):
                torch.cuda.synchronize()
                t = time.perf_counter()
                sides[k]().collect()
                torch.cuda.synchronize()
                runs[k].append(time.perf_counter() - t)
        emit({"phase": f"{name}_fusion_ab", "fused_s": runs[0],
              "unfused_s": runs[1],
              "fused_median": statistics.median(runs[0]),
              "unfused_median": statistics.median(runs[1]),
              "fused_quartiles": statistics.quantiles(runs[0], n=4),
              "unfused_quartiles": statistics.quantiles(runs[1], n=4),
              "fused_wins": sum(a < b for a, b in zip(*runs))})


# -- phase 9 ------------------------------------------------------------------

Q72_CONF = {"spark.sql.shuffle.partitions": "200",
            "spark.rapids.sql.adaptive.coalescePartitions.enabled": "false"}
Q72_PARTITIONS = 200
Q72_KERNELS = ("fused_segment", "compaction_map", "gather",
               "gather_strings", "concat", "murmur3", "hash_string",
               "partition", "sort",
               "string_sort_keys", "string_rows_equal_prev",
               "segmented_sum", "join_build", "join_probe", "join_expand",
               "join_multi_build", "conditional_join_maps",
               "join_probe_left", "join_multi_probe_left",
               "gather_null_extend")
INV_ROWS = tpcds.SF10_INVENTORY_ROWS
CR_ROWS = tpcds.SF10_CATALOG_RETURNS_ROWS
WAREHOUSES = tpcds.SF10_WAREHOUSE_ROWS
CS_ORDER_POOL = ["cs_item_sk", "cs_order_number"]


def q72_dims():
    """q72's small dimension tables on the host, cut as the generators'
    key ranges force: warehouse 10 rows (SF10's count), promotion 300
    (SF10: 500), customer_demographics 1,000 (SF10: 1,920,800),
    household_demographics 100 (SF10: 7,200)."""
    return {"warehouse": tpcds.gen_warehouse("cpu", WAREHOUSES),
            "promo": tpcds.gen_promotion("cpu"),
            "cd": tpcds.gen_customer_demographics("cpu"),
            "hd": tpcds.gen_household_demographics("cpu")}


def lookup(batch: ColumnarBatch, key: str, value: str) -> dict:
    return dict(zip(batch.column(key).to_pylist(),
                    batch.column(value).to_pylist()))


class Q72Numpy:
    """Independent q72 over host arrays.  The inner joins commute with the
    filters, so each sale is kept only where its sale date is in 1999, its
    ship date more than 5 days later, its customer demographics 'D' and
    its household '>10000' (each looked up in its dimension table); the
    inventory rows only where their week holds a 1999 day.  The
    inventory join then pairs (item, week) through packed int64 keys, sort
    and searchsorted, and keeps on hand < quantity; the promotion left
    join is a lookup, the returns left join a count per (item, order)
    (a sale with k returns is k rows, with none one row); the groups are
    (item, warehouse, week), which decide q72's three group keys."""

    def __init__(self, date: ColumnarBatch, item: ColumnarBatch, dims):
        self.year = date.column("d_year").to_numpy()[0]
        self.week = date.column("d_week_seq").to_numpy()[0]
        self.ord = date.column("d_date_ord").to_numpy()[0]
        self.weeks = np.unique(self.week[self.year == 1999])
        self.item_desc = lookup(item, "i_item_sk", "i_item_desc")
        self.wh_name = lookup(dims["warehouse"], "w_warehouse_sk",
                              "w_warehouse_name")
        self.cd_ok = self._flags(lookup(dims["cd"], "cd_demo_sk",
                                        "cd_marital_status"), "D")
        self.hd_ok = self._flags(lookup(dims["hd"], "hd_demo_sk",
                                        "hd_buy_potential"), ">10000")
        promo = dims["promo"].column("p_promo_sk").to_numpy()[0]
        self.promo = np.zeros(int(promo.max()) + 1, bool)
        self.promo[promo] = True
        self.sales, self.inv, self.returns = [], [], []

    @staticmethod
    def _flags(values: dict, want: str) -> np.ndarray:
        out = np.zeros(max(values) + 1, bool)
        for k, v in values.items():
            out[k] = v == want
        return out

    def _date(self, sk):
        i = sk.astype(np.int64) - 2450000
        ok = (i >= 0) & (i < len(self.year))
        return ok, np.where(ok, i, 0)

    @staticmethod
    def _in(flags, keys, valid=None):
        ok = (keys >= 0) & (keys < len(flags))
        ok &= flags[np.where(ok, keys, 0)]
        return ok if valid is None else ok & valid

    def add_catalog_sales(self, data, validity) -> None:
        sold_ok, sold = self._date(data["cs_sold_date_sk"])
        ship_ok, ship = self._date(data["cs_ship_date_sk"])
        ok = sold_ok & ship_ok & (self.year[sold] == 1999)
        ok &= self.ord[ship] > self.ord[sold] + 5
        ok &= self._in(self.cd_ok, data["cs_bill_cdemo_sk"])
        ok &= self._in(self.hd_ok, data["cs_bill_hdemo_sk"])
        promo = self._in(self.promo, data["cs_promo_sk"],
                         validity.get("cs_promo_sk"))
        self.sales.append({
            "item": data["cs_item_sk"][ok],
            "order": data["cs_order_number"][ok],
            "qty": data["cs_quantity"][ok], "week": self.week[sold[ok]],
            "promo": promo[ok]})

    def add_inventory(self, data) -> None:
        ok, day = self._date(data["inv_date_sk"])
        week = self.week[day]
        ok &= np.isin(week, self.weeks)
        self.inv.append({"item": data["inv_item_sk"][ok], "week": week[ok],
                         "wh": data["inv_warehouse_sk"][ok],
                         "on_hand": data["inv_quantity_on_hand"][ok]})

    def add_catalog_returns(self, data) -> None:
        self.returns.append(Q25Numpy._pack(data["cr_item_sk"],
                                           data["cr_order_number"]))

    def result(self, limit: int = 100):
        """(the first ``limit`` rows in q72's order, the groups, the
        inventory join's rows)."""
        s, v = Q25Numpy._cat(self.sales), Q25Numpy._cat(self.inv)
        li, ri = Q25Numpy._join(Q25Numpy._pack(s["item"], s["week"]),
                                Q25Numpy._pack(v["item"], v["week"]))
        keep = v["on_hand"][ri] < s["qty"][li]
        li, ri = li[keep], ri[keep]
        ret = np.sort(np.concatenate(self.returns))
        sk = Q25Numpy._pack(s["item"][li], s["order"][li])
        mult = np.maximum(np.searchsorted(ret, sk, "right")
                          - np.searchsorted(ret, sk, "left"), 1)
        wh_ok = np.isin(v["wh"][ri], list(self.wh_name))
        item_ok = np.isin(s["item"][li], list(self.item_desc))
        li, ri, mult = li[wh_ok & item_ok], ri[wh_ok & item_ok], \
            mult[wh_ok & item_ok]
        group = ((s["item"][li].astype(np.int64) << 24)
                 | (v["wh"][ri].astype(np.int64) << 12)
                 | s["week"][li].astype(np.int64))
        keys, inv = np.unique(group, return_inverse=True)
        total = np.bincount(inv, mult, len(keys)).astype(np.int64)
        promo = np.bincount(inv, mult * s["promo"][li],
                            len(keys)).astype(np.int64)
        rows = [(self.item_desc[int(k >> 24)],
                 self.wh_name[int((k >> 12) & 0xFFF)], int(k & 0xFFF),
                 int(t - p), int(p), int(t))
                for k, t, p in zip(keys, total, promo)]
        rows.sort(key=lambda r: (-r[5], r[0], r[1], r[2]))
        return rows[:limit], len(keys), len(li)


def phase_q72_data(dev, cs_batches, order_pool, ref: "Q72Numpy", dims,
                   q3_dfs):
    """inventory and catalog_returns on the card; the dataframes of q72,
    in a session of 200 shuffle partitions with the coalesced reader off;
    the numpy result."""
    t0 = time.perf_counter()
    inv_batches = []
    for data, _ in tpcds.iter_inventory(INV_ROWS, ITEM_ROWS, WAREHOUSES,
                                        batch_rows=N):
        ref.add_inventory(data)
        inv_batches.append(tpcds.fact_batch(data, {}, tpcds.INVENTORY_SCHEMA,
                                            dev))
    cr_batches = []
    for data, validity in tpcds.iter_catalog_returns(
            CR_ROWS, ITEM_ROWS, order_pool=order_pool, match_frac=0.6,
            batch_rows=N):
        ref.add_catalog_returns(data)
        cr_batches.append(tpcds.fact_batch(
            data, validity, tpcds.CATALOG_RETURNS_SCHEMA, dev))
    torch.cuda.synchronize()
    want, groups, pairs = ref.result()
    resident = sum(t.nbytes for b in inv_batches + cr_batches
                   for c in b.columns for t in (c.data, c.validity))
    emit({"phase": "q72_data", "inventory_rows": INV_ROWS,
          "inventory_batches": len(inv_batches),
          "catalog_returns_rows": CR_ROWS,
          "dims": {k: b.num_rows for k, b in dims.items()},
          "resident_bytes_added": resident, "numpy_q72_groups": groups,
          "numpy_inventory_join_rows": pairs,
          "setup_seconds": time.perf_counter() - t0})
    sess = GpuSession(Q72_CONF)
    _, dd_df, item_df = q3_dfs
    one = lambda b: sess.create_dataframe([to_device(b, dev)])  # noqa: E731
    dfs = (sess.create_dataframe(cs_batches, num_partitions=4),
           sess.create_dataframe(inv_batches, num_partitions=4),
           one(dims["warehouse"]), item_df, one(dims["cd"]), one(dims["hd"]),
           dd_df, one(dims["promo"]),
           sess.create_dataframe(cr_batches, num_partitions=4))
    return dfs, want


def check_q72_plan(plan) -> dict:
    """The inventory join is a shuffled join with the condition that took
    the streamed probe in all 200 partitions; the returns join went
    shuffled as a left join; promotion broadcasts as a left join."""
    nodes = list(plan_nodes(plan))

    def right(n):
        return n.children[1].schema.names

    inv = [n for n in nodes if isinstance(n, GpuShuffledHashJoinExec)
           and "inv_item_sk" in right(n)]
    require(len(inv) == 1 and inv[0].condition is not None,
            "the inventory join is not one shuffled join with a condition")
    inv = inv[0]
    require(inv.branches == {"streamed": Q72_PARTITIONS},
            f"the inventory join's branches: {dict(inv.branches)}")
    cr = [n for n in nodes if isinstance(n, GpuAdaptiveJoinExec)
          and "cr_item_sk" in right(n)]
    require(len(cr) == 1 and cr[0].chosen == "shuffled"
            and cr[0].join_type == "left"
            and isinstance(cr[0].inner, GpuShuffledHashJoinExec)
            and cr[0].inner.join_type == "left",
            "the catalog_returns join did not go shuffled as a left join")
    promo = [n for n in nodes if isinstance(n, GpuBroadcastHashJoinExec)
             and "p_promo_sk" in right(n)]
    require(len(promo) == 1 and promo[0].join_type == "left",
            "the promotion join is not a broadcast left join")
    return {"inventory_join": {
                "partitions": inv.branches["streamed"],
                "largest_build_rows": inv.largest_build_rows,
                "target_rows": inv.target_rows,
                "condition": repr(inv.condition),
                "output_rows": inv.output_rows.value},
            "returns_join": {"chosen": cr[0].chosen,
                             "largest_build_rows":
                                 cr[0].inner.largest_build_rows,
                             "branches": dict(cr[0].inner.branches)}}


def check_q72_rows(rows, want) -> None:
    require(len(rows) == len(want) == 100,
            f"q72 gave {len(rows)} rows, numpy {len(want)}")
    for g, w in zip(rows, want):
        require(tuple(g) == w, f"q72 row {g} where numpy has {w}")


def phase_q72(dfs, want) -> dict:
    query = lambda _: tpcds.q72(*dfs)  # noqa: E731
    rows, plan, launches, first, prof = run_phase_path("q72", query,
                                                       Q72_KERNELS)
    emit({"phase": "q72_plan", "first_run_s": first,
          **check_q72_plan(plan)})
    check_q72_rows(rows, want)
    scanned = CS_ROWS + INV_ROWS + CR_ROWS
    # one timed run (q72 takes ~20 s a run, q14a ~40 s): the script's
    # time limit holds every phase
    timing = time_path("q72", query, None, scanned, prof, runs=1)
    emit({"phase": "q72", "fact_rows": scanned, "rows": len(rows),
          "first_rows": rows[:3], **timing})
    return launches


# -- phase 10 -----------------------------------------------------------------

CHANNELS = ("catalog", "store", "web")     # q14a's and q5's channel order
CHANNEL_SALES_ROWS = {"store": SS_ROWS, "catalog": CS_ROWS,
                      "web": tpcds.SF10_WEB_SALES_ROWS}
CHANNEL_RETURNS_ROWS = {"store": SR_ROWS, "catalog": CR_ROWS,
                        "web": tpcds.SF10_WEB_RETURNS_ROWS}
CHANNEL_SEEDS = {"store": (41, 19), "catalog": (43, 20), "web": (47, 21)}
Q14A_CONF = Q72_CONF
Q14A_KERNELS = ("join_multi_probe_semi", "join_expand_left_only",
                "join_multi_build", "join_build", "join_probe",
                "join_expand", "murmur3", "hash_string", "partition", "sort",
                "string_sort_keys", "segmented_sum", "gather", "concat",
                "masked_sum")
Q5_KERNELS = ("join_build", "join_probe", "join_expand", "murmur3",
              "hash_string", "partition", "sort", "string_sort_keys",
              "segmented_sum", "gather", "concat")
SEMI_ANTI_KERNELS = ("join_probe_semi", "join_probe_anti",
                     "join_multi_probe_anti", "join_expand_left_only")
F64_RTOL_Q14A = 1e-9             # against numpy's integer-cent sums
F64_RTOL_THRESHOLD = 1e-12       # the card's mean against numpy's


class ChannelNumpy:
    """Independent q14a, q5 and semi_anti over host arrays.  Every sale's
    item triple comes from the item table by its key (the branded join
    keeps every row: every item exists); a price and a profit are exact
    integer cents (``np.round(x, 2)`` is ``rint(x * 100) / 100``).  q14a:
    the cross items are the intersection of the three channels' triple
    sets, a semi join is ``np.isin``, the threshold the mean of all the
    prices in cents, the rollup sums and counts by np.unique and bincount.
    q5: each channel's sales and returns in January 2000, by (channel, id)
    and rolled up.  semi_anti: the store rows of a hot item (category <=
    3), not sold in 2000, whose triple the web did not sell in January
    2000."""

    def __init__(self, tables):
        date, _, d, i = tables
        self.year, self.moy = d["d_year"], d["d_moy"]
        self.triple = np.zeros(ITEM_ROWS + 1, np.int64)
        self.triple[i["i_item_sk"]] = pack3(
            i["i_brand_id"], i["i_manufact_id"], i["i_category_id"])
        self.hot = np.zeros(ITEM_ROWS + 1, bool)
        self.hot[i["i_item_sk"]] = i["i_category_id"] <= 3
        self.sales = {c: [] for c in CHANNELS}
        self.returns = {c: [] for c in CHANNELS}

    def _day(self, date_sk):
        return date_sk.astype(np.int64) - 2450000

    def january_2000(self, date_sk) -> np.ndarray:
        day = self._day(date_sk)
        return (self.year[day] == 2000) & (self.moy[day] == 1)

    def add_sales(self, ch: str, data) -> None:
        self.sales[ch].append({
            "triple": self.triple[data["cs_item_sk"]],
            "item": data["cs_item_sk"], "date": data["cs_sold_date_sk"],
            "id": data["cs_channel_sk"],
            "price": cents(data["cs_ext_sales_price"]),
            "profit": cents(data["cs_net_profit"])})

    def add_returns(self, ch: str, data) -> None:
        ok = self.january_2000(data["cr_returned_date_sk"])
        self.returns[ch].append({
            "id": data["cr_channel_sk"][ok],
            "amount": cents(data["cr_return_amount"][ok]),
            "loss": cents(data["cr_net_loss"][ok])})

    def finish(self) -> None:
        self.sales = {c: Q25Numpy._cat(v) for c, v in self.sales.items()}
        self.returns = {c: Q25Numpy._cat(v) for c, v in self.returns.items()}

    def threshold(self) -> tuple:
        """(the mean price in cents as an exact (sum, count), the mean)."""
        total = sum(int(s["price"].sum()) for s in self.sales.values())
        count = sum(len(s["price"]) for s in self.sales.values())
        return total, count, total / count / 100

    def prices_between(self, a: float, b: float) -> int:
        """The prices that one threshold keeps and the other drops."""
        return sum(int(((s["price"] / 100 > a) != (s["price"] / 100 > b))
                       .sum()) for s in self.sales.values())

    def q14a(self, thr: float) -> list:
        """q14a's rows: (channel, brand, category, sales cents, n), in
        q14a's order (keys ascending with nulls first; they are unique)."""
        sets = [np.unique(self.sales[c]["triple"]) for c in
                ("store", "catalog", "web")]
        cross = np.intersect1d(np.intersect1d(sets[0], sets[1]), sets[2])
        mask = 2**21 - 1
        rows = []
        grand = [0, 0]
        for ch in CHANNELS:
            s = self.sales[ch]
            keep = (s["price"] / 100 > thr) & np.isin(s["triple"], cross)
            t, p = s["triple"][keep], s["price"][keep]
            if not len(p):
                continue
            brand, cat = t >> 42, t & mask
            for key, unpack in (((brand << 21) | cat,
                                 lambda k: (k >> 21, k & mask)),
                                (brand, lambda k: (k, None))):
                keys, inv = np.unique(key, return_inverse=True)
                sums = np.bincount(inv, p, len(keys)).astype(np.int64)
                ns = np.bincount(inv, None, len(keys)).astype(np.int64)
                for k, sm, nn in zip(keys.tolist(), sums.tolist(),
                                     ns.tolist()):
                    rows.append((ch, *unpack(k), sm, nn))
            rows.append((ch, None, None, int(p.sum()), len(p)))
            grand = [grand[0] + int(p.sum()), grand[1] + len(p)]
        rows.append((None, None, None, *grand))
        return sorted(rows, key=lambda r: (
            r[0] is not None, r[0] or "", r[1] is not None, r[1] or 0,
            r[2] is not None, r[2] or 0))

    def q5(self) -> list:
        """q5's rows: (channel, id, sales, returns, profit) in cents."""
        rows = []
        grand = np.zeros(3, np.int64)
        for ch in CHANNELS:
            s, r = self.sales[ch], self.returns[ch]
            ok = self.january_2000(s["date"])
            ids = np.concatenate([s["id"][ok], r["id"]])
            vals = [np.concatenate([s["price"][ok],
                                    np.zeros(len(r["id"]), np.int64)]),
                    np.concatenate([np.zeros(int(ok.sum()), np.int64),
                                    r["amount"]]),
                    np.concatenate([s["profit"][ok], -r["loss"]])]
            keys, inv = np.unique(ids, return_inverse=True)
            sums = [np.bincount(inv, v, len(keys)).astype(np.int64)
                    for v in vals]
            for j, k in enumerate(keys.tolist()):
                rows.append((ch, k, *(int(x[j]) for x in sums)))
            sub = np.array([int(v.sum()) for v in vals], np.int64)
            rows.append((ch, None, *sub.tolist()))
            grand += sub
        rows.append((None, None, *grand.tolist()))
        return sorted(rows, key=lambda r: (r[0] is not None, r[0] or "",
                                           r[1] is not None, r[1] or 0))

    def semi_anti(self) -> tuple:
        """(rows, price cents) of the semi_anti path's store rows."""
        web = self.sales["web"]
        month = np.unique(web["triple"][self.january_2000(web["date"])])
        s = self.sales["store"]
        keep = self.hot[s["item"]] & (self.year[self._day(s["date"])]
                                      != 2000)
        keep &= ~np.isin(s["triple"], month)
        return int(keep.sum()), int(s["price"][keep].sum())


def semi_anti_query(ss, ws, item, dd, month):
    """The semi_anti path: the store sales of a hot item (category <= 3,
    a one-key semi join), not sold in 2000 (a one-key anti join), whose
    (brand, manufacturer, category) the web did not sell in January 2000
    (a three-key anti join), counted and summed."""
    col, lit = E.col, E.lit
    keys = ["i_brand_id", "i_manufact_id", "i_category_id"]
    hot = item.filter(col("i_category_id") <= lit(3)).select("i_item_sk")
    y2000 = dd.filter(col("d_year") == lit(2000)).select("d_date_sk")
    tri = item.select("i_item_sk", *keys)
    web_month = (ws.filter((col("cs_sold_date_sk") >= lit(month[0]))
                           & (col("cs_sold_date_sk") < lit(month[1])))
                 .join(tri, on=([col("cs_item_sk")], [col("i_item_sk")]))
                 .select(*keys))
    return (ss.join(hot, on=([col("cs_item_sk")], [col("i_item_sk")]),
                    how="left_semi")
            .join(y2000, on=([col("cs_sold_date_sk")], [col("d_date_sk")]),
                  how="left_anti")
            .join(tri, on=([col("cs_item_sk")], [col("i_item_sk")]))
            .join(web_month, on=([col(k) for k in keys],
                                 [col(k) for k in keys]), how="left_anti")
            .agg(E.count().alias("n"),
                 E.sum_("cs_ext_sales_price").alias("sales")))


def phase_channel_data(dev, tables):
    """The three channels' sales and returns on the card, 4 partitions of
    1,048,576-row batches each, in a session of 200 shuffle partitions
    with the coalesced reader off; item and date_dim; the numpy
    results."""
    t0 = time.perf_counter()
    ref = ChannelNumpy(tables)
    sales, returns = {}, {}
    for ch in CHANNELS:
        sseed, rseed = CHANNEL_SEEDS[ch]
        sales[ch] = []
        for data, validity in tpcds.iter_channel_sales(
                CHANNEL_SALES_ROWS[ch], ITEM_ROWS, sseed, batch_rows=N):
            ref.add_sales(ch, data)
            sales[ch].append(tpcds.fact_batch(
                data, validity, tpcds.CHANNEL_SALES_SCHEMA, dev))
        returns[ch] = []
        for data, validity in tpcds.iter_channel_returns(
                CHANNEL_RETURNS_ROWS[ch], ITEM_ROWS, rseed, batch_rows=N):
            ref.add_returns(ch, data)
            returns[ch].append(tpcds.fact_batch(
                data, validity, tpcds.CHANNEL_RETURNS_SCHEMA, dev))
    ref.finish()
    torch.cuda.synchronize()
    resident = sum(t.nbytes for bs in (*sales.values(), *returns.values())
                   for b in bs for c in b.columns
                   for t in (c.data, c.validity))
    sess = GpuSession(Q14A_CONF, device=dev)
    dfs = {ch: (sess.create_dataframe(sales[ch], num_partitions=4),
                sess.create_dataframe(returns[ch], num_partitions=4))
           for ch in CHANNELS}
    item_df = sess.create_dataframe([to_device(tables[1], dev)])
    dd_df = sess.create_dataframe([to_device(tables[0], dev)])
    emit({"phase": "channel_data",
          "sales_rows": {c: CHANNEL_SALES_ROWS[c] for c in CHANNELS},
          "returns_rows": {c: CHANNEL_RETURNS_ROWS[c] for c in CHANNELS},
          "item_rows": tables[1].num_rows, "resident_bytes_added": resident,
          "setup_seconds": time.perf_counter() - t0})
    return dfs, item_df, dd_df, ref


def check_q14a_plan(plan) -> dict:
    """Every semi join is a shuffled join that took the streamed probe in
    all 200 partitions; the largest build partition of each."""
    semi = [n for n in plan_nodes(plan)
            if getattr(n, "join_type", None) == "left_semi"]
    require(len(semi) == 9 and all(
        isinstance(n, GpuShuffledHashJoinExec) for n in semi),
        f"q14a's semi joins: {[type(n).__name__ for n in semi]}")
    for n in semi:
        require(n.branches == {"streamed": Q72_PARTITIONS},
                f"a q14a semi join's branches: {dict(n.branches)}")
    return {"semi_joins": [{"largest_build_rows": n.largest_build_rows,
                            "output_rows": n.output_rows.value}
                           for n in semi]}


def check_float_rows(name: str, rows, want, nkeys: int) -> float:
    """Keys and counts exact, in order; every sum within F64_RTOL_Q14A of
    numpy's integer cents (at least that much of one unit absolute);
    returns the largest relative error."""
    require(len(rows) == len(want), f"{name} gave {len(rows)} rows, numpy "
            f"{len(want)}")
    worst = 0.0
    for g, w in zip(rows, want):
        require(tuple(g[:nkeys]) == tuple(w[:nkeys]),
                f"{name} row {g} where numpy has {w}")
        for a, b in zip(g[nkeys:], w[nkeys:]):
            if isinstance(a, float):
                b = b / 100
                err = abs(a - b) / max(abs(b), 1.0)
                require(err <= F64_RTOL_Q14A, f"{name} sum {a} against "
                        f"numpy {b} in {g}")
                worst = max(worst, err)
            else:
                require(a == b, f"{name} count {a} against {b} in {g}")
    return worst


def phase_q14a(dfs, item_df, ref: ChannelNumpy) -> dict:
    ss, cs, ws = (dfs[c][0] for c in ("store", "catalog", "web"))
    query = lambda _: tpcds.q14a(ss, cs, ws, item_df)  # noqa: E731
    rows, plan, launches, first, prof = run_phase_path("q14a", query,
                                                       Q14A_KERNELS)
    emit({"phase": "q14a_plan", "first_run_s": first,
          **check_q14a_plan(plan)})
    # the scalar subquery once more, held against numpy's mean
    thr = tpcds.q14a_threshold(ss, cs, ws)
    total, count, mean = ref.threshold()
    require(abs(thr - mean) <= F64_RTOL_THRESHOLD * abs(mean),
            f"q14a's threshold {thr} against numpy's {mean}")
    between = ref.prices_between(thr, mean)
    require(between == 0, f"{between} prices lie between the card's "
            f"threshold {thr} and numpy's {mean}")
    want = ref.q14a(mean)
    worst = check_float_rows("q14a", rows, want, 3)
    scanned = sum(CHANNEL_SALES_ROWS.values())
    timing = time_path("q14a", query, None, scanned, prof, runs=1)
    emit({"phase": "q14a", "fact_rows": scanned, "rows": len(rows),
          "threshold": thr, "numpy_threshold": mean,
          "numpy_price_cents": [total, count], "max_rel_err": worst,
          "first_rows": rows[:3], **timing})
    return launches


def phase_q5(dfs, dd_df, ref: ChannelNumpy) -> dict:
    query = lambda _: tpcds.q5(  # noqa: E731
        {c: dfs[c] for c in CHANNELS}, dd_df)
    rows, plan, launches, first, prof = run_phase_path("q5", query,
                                                       Q5_KERNELS)
    worst = check_float_rows("q5", rows, ref.q5(), 2)
    scanned = sum(CHANNEL_SALES_ROWS.values()) + sum(
        CHANNEL_RETURNS_ROWS.values())
    timing = time_path("q5", query, None, scanned, prof)
    emit({"phase": "q5", "fact_rows": scanned, "rows": len(rows),
          "first_run_s": first, "max_rel_err": worst,
          "first_rows": rows[:3], **timing})
    return launches


def phase_semi_anti(dfs, item_df, dd_df, tables, ref: ChannelNumpy) -> dict:
    d = tables[2]
    days = d["d_date_sk"][(d["d_year"] == 2000) & (d["d_moy"] == 1)]
    month = (int(days.min()), int(days.max()) + 1)
    query = lambda _: semi_anti_query(  # noqa: E731
        dfs["store"][0], dfs["web"][0], item_df, dd_df, month)
    rows, plan, launches, first, prof = run_phase_path(
        "semi_anti", query, SEMI_ANTI_KERNELS)
    n, price = ref.semi_anti()
    require(len(rows) == 1 and rows[0][0] == n,
            f"semi_anti counted {rows}, numpy {n}")
    err = abs(rows[0][1] - price / 100) / max(price / 100, 1.0)
    require(err <= F64_RTOL_Q14A, f"semi_anti summed {rows[0][1]}, numpy "
            f"{price / 100}")
    joins = [(n.join_type, type(n).__name__) for n in plan_nodes(plan)
             if getattr(n, "join_type", None) in SEMI_TYPES]
    adaptive = [n for n in plan_nodes(plan)
                if isinstance(n, GpuAdaptiveJoinExec)
                and n.join_type == "left_anti"]
    require(len(adaptive) == 1 and len(adaptive[0].left_keys) == 3
            and adaptive[0].chosen == "broadcast",
            "the three-key anti join is not an adaptive join that "
            "broadcast")
    timing = time_path("semi_anti", query, None, SS_ROWS, prof)
    emit({"phase": "semi_anti", "rows": rows, "numpy": [n, price],
          "first_run_s": first, "joins": joins, **timing})
    return launches


# -- phase 11 -----------------------------------------------------------------

#: the cut dimensions: (rows drawn, rows at real SF10); the fact
#: generators draw their keys in the reference generators' ranges
GAUNTLET_CUTS = {"customer": (50_000, 500_000),
                 "customer_address": (25_000, 250_000),
                 "store": (50, 102), "customer_demographics": (1_000, 1_920_800),
                 "household_demographics": (100, 7_200),
                 "promotion": (300, 500)}
GAUNTLET_ARGS = {"q42": ("ss", "dd", "item"), "q52": ("ss", "dd", "item"),
                 "q55": ("ss", "dd", "item"),
                 "q96": ("ss", "hd", "td", "store"),
                 "q7": ("ss", "cd", "dd", "item", "promo"),
                 "q26": ("cs", "cd", "dd", "item", "promo"),
                 "q19": ("ss", "dd", "item", "customer", "ca", "store")}
#: (moy, year, manager) of q42, q52 and q55
MONTH_QUERIES = {"q42": (11, 2000, 1), "q52": (12, 1998, 1),
                 "q55": (11, 1999, 28)}
JOIN_KERNELS = ("join_build", "join_probe", "join_expand", "gather",
                "fused_segment")
GROUPED_KERNELS = JOIN_KERNELS + ("murmur3", "hash_string", "partition",
                                  "sort", "string_sort_keys",
                                  "string_rows_equal_prev", "segmented_sum",
                                  "concat")
GAUNTLET_KERNELS = {
    "q42": GROUPED_KERNELS, "q52": GROUPED_KERNELS, "q55": GROUPED_KERNELS,
    "q96": JOIN_KERNELS + ("compaction_map", "string_sort_keys"),
    "q7": GROUPED_KERNELS + ("compaction_map",),
    "q26": GROUPED_KERNELS + ("compaction_map",),
    "q19": GROUPED_KERNELS + ("compaction_map", "substring")}
F64_RTOL_GAUNTLET = 1e-9         # against numpy's integer-cent sums
GAUNTLET_NKEYS = {"q42": 3, "q52": 3, "q55": 2, "q96": 0, "q7": 1,
                  "q26": 1, "q19": 3}


def keyed(batch: ColumnarBatch, key: str, name: str) -> np.ndarray:
    """A dimension column as an array indexed by the dimension's key."""
    keys = batch.column(key).to_numpy()[0]
    col = batch.column(name)
    vals = (np.array(col.to_pylist(), dtype=object) if col.is_string
            else col.to_numpy()[0])
    out = np.zeros(int(keys.max()) + 1, dtype=vals.dtype)
    out[keys] = vals
    return out


class GauntletNumpy:
    """Independent q7, q19, q26, q42, q52, q55 and q96 over host arrays.
    Every dimension is an array indexed by its key and every dimension
    filter a boolean array by key (the fact generators draw each key in
    its dimension's range, so every non-null key exists); the inner joins
    commute with the filters, so each fact chunk keeps, per query, the
    rows whose keys all pass (a null customer or promotion key joins
    nothing), with the item, the quantity and the prices in integer
    cents.  The groups come from the item's columns (every group key is a
    column of item or a constant year); sums are exact cents; rows come
    in each query's order, with numpy's exact order values beside them."""

    def __init__(self, tables, dims):
        date, item, d, _ = tables
        self.year, self.moy = d["d_year"], d["d_moy"]
        self.item = {n: keyed(item, "i_item_sk", n) for n in (
            "i_item_id", "i_brand_id", "i_brand", "i_manufact_id",
            "i_category_id", "i_category", "i_manager_id")}
        self.dims = {"cd": dims["cd"], "promo": dims["promo"],
                     "hd": dims["hd"], "store": tpcds.gen_store("cpu"),
                     "customer": tpcds.gen_customer("cpu"),
                     "ca": tpcds.gen_customer_address("cpu"),
                     "td": tpcds.gen_time_dim("cpu")}
        cd, promo = self.dims["cd"], self.dims["promo"]
        hd, store, td = self.dims["hd"], self.dims["store"], self.dims["td"]

        def cd_is(g, m, e):
            return ((keyed(cd, "cd_demo_sk", "cd_gender") == g)
                    & (keyed(cd, "cd_demo_sk", "cd_marital_status") == m)
                    & (keyed(cd, "cd_demo_sk", "cd_education_status") == e))
        self.cd7 = cd_is("M", "S", "College")
        self.cd26 = cd_is("F", "W", "Primary")
        self.promo_n = (
            (keyed(promo, "p_promo_sk", "p_channel_email") == "N")
            | (keyed(promo, "p_promo_sk", "p_channel_event") == "N"))
        self.hd4 = keyed(hd, "hd_demo_sk", "hd_dep_count") == 4
        self.ese = keyed(store, "s_store_sk", "s_store_name") == "ese"
        self.t_ok = ((keyed(td, "t_time_sk", "t_hour") == 20)
                     & (keyed(td, "t_time_sk", "t_minute") >= 30))
        self.c_addr = keyed(self.dims["customer"], "c_customer_sk",
                            "c_current_addr_sk")
        # the zips are five ASCII digits: SUBSTRING(zip, 1, 5) is the zip
        self.ca_zip = keyed(self.dims["ca"], "ca_address_sk",
                            "ca_zip").astype(np.int64)
        self.s_zip = keyed(store, "s_store_sk", "s_zip").astype(np.int64)
        self.parts = {q: [] for q in GAUNTLET_ARGS if q != "q96"}
        # the ca_zip of q19's rows of store_sales' first partition
        # (chunks 0, 4, ..., 24 of phase 7's 4 partitions, which the joins
        # stream as one): SUBSTRING's shape in one q19 call
        self.q19_zips = []
        self.q96 = 0
        self.scanned = {"ss": 0, "cs": 0}
        # q98: each item's cents in its dates, of its three categories
        self.item["i_item_desc"] = keyed(item, "i_item_sk", "i_item_desc")
        self.q98_item = np.isin(self.item["i_category"].astype(str),
                                tpcds.Q98_CATEGORIES)
        self.q98_cents = np.zeros(len(self.q98_item), np.int64)
        self.q98_count = np.zeros(len(self.q98_item), np.int64)

    def _calendar(self, date_sk):
        """(year, month) of each date key; -1 for a key date_dim has not
        (catalog_sales drawn from the returns' pool may be sold past
        2003)."""
        i = date_sk.astype(np.int64) - 2450000
        ok = (i >= 0) & (i < len(self.year))
        j = np.where(ok, i, 0)
        return np.where(ok, self.year[j], -1), np.where(ok, self.moy[j], -1)

    def q19_rows(self, data, validity) -> np.ndarray:
        """The rows q19's date, item and customer joins keep."""
        year, moy = self._calendar(data["ss_sold_date_sk"])
        return ((moy == 11) & (year == 1999)
                & (self.item["i_manager_id"][data["ss_item_sk"]] == 8)
                & validity["ss_customer_sk"])

    def _averaged(self, q, cd_ok, p, data, validity) -> None:
        """q7's or q26's rows (prefix p: ss or cs)."""
        year, _ = self._calendar(data[f"{p}_sold_date_sk"])
        promo = f"{p}_promo_sk"
        cdemo = "ss_cdemo_sk" if p == "ss" else "cs_bill_cdemo_sk"
        keep = (cd_ok[data[cdemo]] & (year == 2000)
                & validity[promo] & self.promo_n[data[promo]])
        self.parts[q].append(
            (data[f"{p}_item_sk"][keep],
             data[f"{p}_quantity"][keep].astype(np.int64),
             cents(data[f"{p}_ext_sales_price"][keep]),
             cents(data[f"{p}_net_profit"][keep])))

    def add_store_sales(self, data, validity) -> None:
        first_partition = self.scanned["ss"] // N % 4 == 0
        self.scanned["ss"] += len(data["ss_item_sk"])
        year, moy = self._calendar(data["ss_sold_date_sk"])
        item = data["ss_item_sk"]
        manager = self.item["i_manager_id"][item]
        price = cents(data["ss_ext_sales_price"])
        for q, (m, y, mgr) in MONTH_QUERIES.items():
            keep = (moy == m) & (year == y) & (manager == mgr)
            self.parts[q].append((item[keep], price[keep]))
        keep = self.q19_rows(data, validity)
        addr = self.c_addr[data["ss_customer_sk"][keep]]
        if first_partition:
            self.q19_zips.append(self.ca_zip[addr])
        differ = self.ca_zip[addr] != self.s_zip[data["ss_store_sk"][keep]]
        self.parts["q19"].append((item[keep][differ], price[keep][differ]))
        self._averaged("q7", self.cd7, "ss", data, validity)
        day = data["ss_sold_date_sk"].astype(np.int64) - 2450000
        keep = ((day >= tpcds.Q98_FIRST_DAY) & (day <= tpcds.Q98_LAST_DAY)
                & self.q98_item[item])
        size = len(self.q98_cents)
        self.q98_cents += np.bincount(item[keep], price[keep],
                                      size).astype(np.int64)
        self.q98_count += np.bincount(item[keep], None, size).astype(
            np.int64)
        self.q96 += int((self.hd4[data["ss_hdemo_sk"]]
                         & self.t_ok[data["ss_sold_time_sk"]]
                         & self.ese[data["ss_store_sk"]]).sum())

    def add_catalog_sales(self, data, validity) -> None:
        self.scanned["cs"] += len(data["cs_item_sk"])
        self._averaged("q26", self.cd26, "cs", data, validity)

    def _cat(self, q):
        parts = self.parts[q]
        return [np.concatenate([x[j] for x in parts])
                for j in range(len(parts[0]))]

    def _sums(self, q, names):
        """(group key tuple -> (cents, rows)) of a sum query, grouped by
        the named item columns."""
        item, price = self._cat(q)
        if not len(item):
            return {}
        code = np.stack([self.item[n][item].astype(np.int64)
                         if self.item[n].dtype != object else
                         np.unique(self.item[n][item].astype(str),
                                   return_inverse=True)[1]
                         for n in names])
        keys, first, inv = np.unique(code, axis=1, return_index=True,
                                     return_inverse=True)
        inv = inv.reshape(-1)
        total = np.bincount(inv, price, keys.shape[1]).astype(np.int64)
        rows = np.bincount(inv, None, keys.shape[1]).astype(np.int64)
        out = {}
        for g in range(keys.shape[1]):
            it = item[first[g]]
            out[tuple(self.item[n][it].item() if self.item[n].dtype != object
                      else self.item[n][it] for n in names)] = (
                int(total[g]), int(rows[g]))
        return out

    def result(self, q) -> list:
        """[(group keys, values, order)] in the query's order: values as
        the port gives them (a sum in cents / 100, an average), order the
        exact tuple the query sorts by."""
        if q == "q96":
            return [((), (self.q96,), ())]
        if q in ("q7", "q26"):
            item, qty, price, profit = self._cat(q)
            keys, inv = np.unique(item, return_inverse=True)
            n = np.bincount(inv).astype(np.int64)
            sums = [np.bincount(inv, v.astype(np.float64), len(keys))
                    for v in (qty, price, profit)]
            out = []
            for g, k in enumerate(keys.tolist()):
                iid = self.item["i_item_id"][k]
                out.append(((iid,), (sums[0][g] / n[g],
                                     sums[1][g] / 100 / n[g],
                                     sums[2][g] / 100 / n[g]), (iid,)))
            return sorted(out, key=lambda r: r[2])
        if q == "q19":
            groups = self._sums(q, ("i_brand_id", "i_brand", "i_manufact_id"))
            out = [(k, (c / 100,), (-c, k[0], k[2]))
                   for k, (c, _) in groups.items()]
        elif q == "q42":
            groups = self._sums(q, ("i_category_id", "i_category"))
            out = [((2000, *k), (c / 100,), (-c, 2000, *k))
                   for k, (c, _) in groups.items()]
        elif q == "q52":
            groups = self._sums(q, ("i_brand_id", "i_brand"))
            out = [((1998, *k), (c / 100,), (1998, -c, k[0]))
                   for k, (c, _) in groups.items()]
        else:
            groups = self._sums(q, ("i_brand_id", "i_brand"))
            out = [(k, (c / 100,), (-c, k[0])) for k, (c, _) in groups.items()]
        return sorted(out, key=lambda r: r[2])

    def q98_rows(self) -> list:
        """(i_item_id, i_item_desc, i_category, i_brand, itemrevenue,
        revenueratio) in q98's order: revenue from exact cents, each
        brand's total the sum of its items' cents."""
        items = np.flatnonzero(self.q98_count)
        brand = self.item["i_brand"][items]
        totals: dict = {}
        for b, c in zip(brand, self.q98_cents[items]):
            totals[b] = totals.get(b, 0) + int(c)
        out = [(self.item["i_item_id"][it], self.item["i_item_desc"][it],
                self.item["i_category"][it], b,
                int(self.q98_cents[it]) / 100,
                int(self.q98_cents[it]) * 100 / totals[b])
               for it, b in zip(items.tolist(), brand)]
        return sorted(out, key=lambda r: (r[2], r[3], r[0], r[1], r[5]))

    def check(self, q, rows, nkeys: int) -> float:
        """The port's rows against numpy's: each row's group is numpy's,
        its counts exact and its sums and averages within
        F64_RTOL_GAUNTLET; at each place numpy's own row has the same
        order value (only groups numpy's exact sums tie may trade
        places); as many rows as the LIMIT keeps.  Returns the largest
        relative error."""
        want = self.result(q)
        require(len(rows) == min(len(want), 100), f"{q} gave {len(rows)} "
                f"rows, numpy {len(want)} groups")
        by_key = {w[0]: w for w in want}
        worst = 0.0
        for pos, (r, w) in enumerate(zip(rows, want)):
            g = by_key.get(tuple(r[:nkeys]))
            require(g is not None, f"{q} gave a group numpy has not: {r}")
            for a, b in zip(r[nkeys:], g[1], strict=True):
                if isinstance(b, float):
                    err = abs(a - b) / max(abs(b), 1.0)
                    require(err <= F64_RTOL_GAUNTLET, f"{q}: {a} against "
                            f"numpy {b} in {r}")
                    worst = max(worst, err)
                else:
                    require(a == b, f"{q}: {a} against numpy {b} in {r}")
            require(g[2] == w[2], f"{q} row {pos} {r} where numpy orders "
                    f"{w}")
        return worst


def phase_gauntlet_data(dev, q25_dfs, ref: GauntletNumpy):
    """The seven queries' tables in the session of phase 7: store_sales
    and catalog_sales as phases 7 and 8 left them on the card, date_dim
    and item, and the dimensions drawn at the generators' sizes."""
    t0 = time.perf_counter()
    ss_df, _, cs_df, dd_df, _, item_df = q25_dfs
    sess = ss_df.session
    dfs = {"ss": ss_df, "cs": cs_df, "dd": dd_df, "item": item_df,
           **{k: sess.create_dataframe([to_device(b, dev)])
              for k, b in ref.dims.items()}}
    torch.cuda.synchronize()
    emit({"phase": "gauntlet_data", "store_sales_rows": ref.scanned["ss"],
          "catalog_sales_rows": ref.scanned["cs"],
          "dimension_rows": {k: b.num_rows for k, b in ref.dims.items()},
          "cut_from_sf10": GAUNTLET_CUTS,
          "setup_seconds": time.perf_counter() - t0})
    require(ref.scanned == {"ss": SS_ROWS, "cs": CS_ROWS},
            f"the numpy side saw {ref.scanned}")
    return dfs


def phase_gauntlet(dfs, ref: GauntletNumpy) -> dict:
    """Each query: its main path traced, with its launches; held against
    numpy; timed.  q19's run counts the calls of ``substring_plain``,
    which must be none: the card ran the kernel."""
    by_query = {}
    plain_calls = []
    plain = SS.substring_plain

    def counted(*args):
        plain_calls.append(1)
        return plain(*args)
    for name, args in GAUNTLET_ARGS.items():
        query = lambda _, name=name, args=args: getattr(  # noqa: E731
            tpcds, name)(*(dfs[k] for k in args))
        SS.substring_plain = counted
        try:
            rows, plan, launches, first, prof = run_phase_path(
                name, query, GAUNTLET_KERNELS[name])
        finally:
            SS.substring_plain = plain
        require(not plain_calls, f"{name} ran substring_plain "
                f"{len(plain_calls)} times on the card")
        worst = ref.check(name, rows, GAUNTLET_NKEYS[name])
        scanned = CS_ROWS if args[0] == "cs" else SS_ROWS
        timing = time_path(name, query, None, scanned, prof)
        emit({"phase": name, "fact_rows": scanned, "rows": len(rows),
              "first_run_s": first, "max_rel_err": worst,
              "first_rows": rows[:3], **timing})
        by_query[name] = launches
    return by_query


# -- phase 12 -----------------------------------------------------------------

# a quarter of TPC-H SF10 lineitem's 60,012,150 rows, for phases 14 and
# 15's time: with them the script took 739.0 s at half this count (on an
# H100 80GB HBM3 at 700 W; the set-up alone 24.26 s, 47.96 s at the
# full count)
HELD_ROWS = SF10_ROWS // 4       # 15,003,037
HELD_SEED = 0
HELD_PARTITIONS = 16
F64_RTOL_HELD = 1e-9             # against numpy's float64 sums
# each held query's kernels that its main path must launch
HELD_KERNELS = {
    "global_aggregate": ("masked_extreme", "masked_sum"),
    "grouped_aggregate": ("segmented_extreme", "segmented_sum", "sort"),
    "global_extremes": ("masked_extreme",),
    "grouped_extremes": ("segmented_extreme", "sort"),
    "global_variance": ("masked_m2", "masked_sum"),
    "grouped_variance": ("segmented_m2", "segmented_sum", "sort"),
    "filtered_global": ("fused_segment", "masked_extreme", "masked_m2"),
}


class HeldNumpy:
    """Independent evaluation of the held queries over the host columns:
    Spark's MIN / MAX (NaN above everything) by ``reduceat`` over the rows
    in group order (the null key first, then keys 0-12, as the port's rows
    are sorted here), sums and counts exact, means and the two-pass M2 in
    float64; a global result from the groups' where that is exact
    (extremes, counts, integer sums), else from all rows.  The columns'
    statistics are computed once, in threads (numpy releases the GIL).
    Each result row comes with which of its values must be exact (keys,
    counts, integer sums, MIN and MAX)."""

    def __init__(self, data, validity):
        self.data, self.validity = data, validity
        gid = np.where(validity["k"], data["k"] + 1, 0).astype(np.int8)
        self.order = np.argsort(gid, kind="stable")
        sg = gid[self.order]
        self.starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
        self.keys = [None if g == 0 else int(g) - 1 for g in sg[self.starts]]
        keep = validity["v"] & (data["v"] > 0)   # filtered_global's filter
        with ThreadPoolExecutor(len(data)) as pool:
            self.grouped = dict(zip(data, pool.map(self._grouped, data)))
            self.total_m2 = dict(zip("xv", pool.map(
                lambda c: self.moments(data[c], validity[c],
                                       np.zeros(1, np.int64))[2], "xv")))
            self.filtered = dict(zip(data, pool.map(
                lambda c: self._stats(data[c], validity[c] & keep,
                                      np.zeros(1, np.int64)), data)))

    def _grouped(self, name: str) -> dict:
        return self._stats(self.data[name][self.order],
                           self.validity[name][self.order], self.starts)

    @classmethod
    def _stats(cls, x, ok, starts) -> dict:
        out = {"min": cls.extreme(x, ok, starts, True),
               "max": cls.extreme(x, ok, starts, False)}
        if x.dtype in (np.int64, np.float64):     # v and x
            out["moments"] = cls.moments(x, ok, starts)
        if x.dtype == np.int64:
            out["isum"] = np.add.reduceat(np.where(ok, x, 0), starts)
        return out

    @staticmethod
    def extreme(x, ok, starts, is_min: bool):
        """(the extreme of the valid non-NaN values, their count, the
        count of valid NaNs) per run: a [runs] value array, two int64."""
        ufunc = np.minimum if is_min else np.maximum
        if x.dtype.kind == "f":
            nan = np.isnan(x)
            take = ok & ~nan
            fill = np.inf if is_min else -np.inf
            nans = np.add.reduceat(ok & nan, starts, dtype=np.int64)
        else:
            x = x.astype(np.int64)
            take = ok
            info = np.iinfo(np.int64)
            fill = info.max if is_min else info.min
            nans = np.zeros(len(starts), np.int64)
        red = ufunc.reduceat(np.where(take, x, fill), starts)
        return red, np.add.reduceat(take, starts, dtype=np.int64), nans

    @staticmethod
    def spark_extreme(parts, is_min: bool, dtype) -> list:
        """Spark's MIN / MAX of each run from ``extreme``'s parts."""
        red, nonnan, nans = parts
        out = []
        for v, a, b in zip(red.tolist(), nonnan.tolist(), nans.tolist()):
            if a + b == 0:
                out.append(None)
            elif dtype.kind == "f" and (b > 0 if not is_min else a == 0):
                out.append(float("nan"))
            else:
                out.append(bool(v) if dtype == np.bool_ else v)
        return out

    @staticmethod
    def moments(x, ok, starts):
        """Per run: (valid count, float64 sum, two-pass M2)."""
        xf = np.where(ok, x.astype(np.float64), 0.0)
        n = np.add.reduceat(ok, starts, dtype=np.int64)
        s = np.add.reduceat(xf, starts)
        with np.errstate(all="ignore"):
            mean = s / np.maximum(n, 1)
            lens = np.diff(np.r_[starts, len(x)])
            d = np.where(ok, xf - np.repeat(mean, lens), 0.0)
        return n, s, np.add.reduceat(d * d, starts)

    @staticmethod
    def variances(n, m2) -> list:
        """Per run: var_samp, var_pop, stddev, stddev_pop (None where the
        divisor is 0)."""
        out = []
        with np.errstate(all="ignore"):
            for ni, mi in zip(n.tolist(), m2.tolist()):
                vs = mi / (ni - 1) if ni > 1 else None
                vp = mi / ni if ni > 0 else None
                out.append((vs, vp, None if vs is None else np.sqrt(vs),
                            None if vp is None else np.sqrt(vp)))
        return out

    def extremes_of(self, c: str, grouped: bool, filtered: bool = False
                    ) -> list:
        """[min per run, max per run] of column c."""
        out = []
        for is_min in (True, False):
            key = "min" if is_min else "max"
            if filtered:
                parts = self.filtered[c][key]
            else:
                parts = self.grouped[c][key]
                if not grouped:   # the groups' extremes combined
                    red, a, b = parts
                    pick = a > 0
                    ufunc = np.minimum if is_min else np.maximum
                    v = ufunc.reduce(red[pick]) if pick.any() else red[0]
                    parts = (np.array([v]), a.sum(keepdims=True),
                             b.sum(keepdims=True))
            out.append(self.spark_extreme(parts, is_min,
                                          self.data[c].dtype))
        return out

    def moments_of(self, c: str, grouped: bool, filtered: bool = False):
        if filtered:
            return self.filtered[c]["moments"]
        n, s, m2 = self.grouped[c]["moments"]
        if grouped:
            return n, s, m2
        return (n.sum(keepdims=True), s.sum(keepdims=True),
                self.total_m2[c])

    def rows(self, name: str):
        """(rows, exact flags of each value) of one held query."""
        grouped = name.startswith("grouped")
        filtered = name == "filtered_global"
        cols, exact = [], []

        def add(values, is_exact):
            cols.append(values)
            exact.append(is_exact)

        def extremes(names):
            for c in names:
                for values in self.extremes_of(c, grouped, filtered):
                    add(values, True)

        def variances(names, which=range(4)):
            for c in names:
                n, _, m2 = self.moments_of(c, grouped, filtered)
                per = self.variances(n, m2)
                for i in which:
                    add([p[i] for p in per], False)

        if name in ("global_aggregate", "grouped_aggregate"):
            st = self.grouped["v"]
            vsum, vn = st["isum"], st["moments"][0]
            if not grouped:
                vsum, vn = vsum.sum(keepdims=True), vn.sum(keepdims=True)
            add(vsum.tolist(), True)
            add(vn.tolist(), True)
            if grouped:
                extremes("x")
                add([s / c if c else None
                     for s, c in zip(vsum.tolist(), vn.tolist())], False)
            else:
                add([len(self.data["v"])], True)
                extremes("v")
                xn, xs, _ = self.moments_of("x", False)
                add([float(xs[0]) / int(xn[0]) if xn[0] else None], False)
        elif name.endswith("extremes"):
            extremes("vxfb" if grouped else "kvxfb")
        elif name.endswith("variance"):
            variances("xv")
        else:   # filtered_global
            extremes("kxfb")
            variances("v", [0])
            variances("x", [3])
        rows = [tuple(c[i] for c in cols) for i in range(len(cols[0]))]
        if grouped:
            rows = [(k, *r) for k, r in zip(self.keys, rows)]
            exact = [True] + exact
        return rows, exact


def held_equal(a, b, is_exact: bool) -> bool:
    if a is None or b is None:
        return a is None and b is None
    if isinstance(b, float) and np.isnan(b):
        return isinstance(a, float) and np.isnan(a)
    if is_exact or a == b:
        return a == b
    return abs(a - b) <= F64_RTOL_HELD * abs(b)


def phase_held_data(dev):
    """The held table on the card: tests/test_queries.py's make_data drawn
    at 15,003,037 rows, batches of 1,048,576, 16 partitions; numpy's
    results of the seven queries."""
    t0 = time.perf_counter()
    data, validity = held.columns(HELD_ROWS, HELD_SEED)
    batches = [batch_from_numpy({c: (data[c][o:o + N], validity[c][o:o + N])
                                 for c in held.SCHEMA.names}, held.SCHEMA,
                                dev) for o in range(0, HELD_ROWS, N)]
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    ref = HeldNumpy(data, validity)
    want = {name: ref.rows(name) for name in held.QUERIES}
    resident = sum(t.nbytes for b in batches for c in b.columns
                   for t in (c.data, c.validity))
    emit({"phase": "held_data", "rows": HELD_ROWS, "batches": len(batches),
          "partitions": HELD_PARTITIONS, "resident_bytes": resident,
          "draw_and_upload_seconds": upload,
          "setup_seconds": time.perf_counter() - t0})
    df = GpuSession().create_dataframe(batches, num_partitions=HELD_PARTITIONS)
    return df, want


def phase_held(df, want) -> dict:
    """Each held query's main path (traced, its launches), held against
    numpy, then timed; the filtered global aggregate must be one fused
    segment that ran once a batch."""
    by_path = {}
    nbatches = -(-HELD_ROWS // N)
    for name, build in held.QUERIES.items():
        query = lambda _, build=build: build(df)  # noqa: E731
        path = f"held_{name}"
        rows, plan, launches, first_wall, profile = run_phase_path(
            path, query, HELD_KERNELS[name])
        rows = sorted(rows, key=lambda r: (r[0] is not None, r[0]))
        exp, exact = want[name]
        require(len(rows) == len(exp),
                f"{path} gave {len(rows)} rows, numpy {len(exp)}")
        for g, w in zip(rows, exp):
            require(all(held_equal(a, b, e) for a, b, e in zip(g, w, exact)),
                    f"{path} row {g} where numpy has {w}")
        extra = {}
        if name == "filtered_global":
            text = query(None).explain()
            require("GpuFusedSegment[HashAggregate <- Filter" in text,
                    f"{path} is not one fused segment: {text}")
            require(launches.get("fused_segment") == nbatches,
                    f"{path} launched fused_segment "
                    f"{launches.get('fused_segment')} times over {nbatches} "
                    "batches")
            extra["fused"] = True
        timing = time_path(path, query, None, HELD_ROWS, profile)
        emit({"phase": path, "rows": HELD_ROWS, "groups": len(rows),
              "first_wall_s": first_wall, "first_row": rows[0], **extra,
              "activities_per_batch": per_batch(timing, nbatches),
              **timing})
        by_path[path] = launches
    return by_path


# -- phase 13 -----------------------------------------------------------------

# a quarter of SF10's 60,012,150: at the full count phase 13 took 59 s
# and the whole script 662 s on an H100 80GB HBM3 at 700 W, and at half
# of it, with phases 14 and 15, the script took 739.0 s
TAIL_ROWS = SF10_ROWS // 4       # 15,003,037
TAIL_SEED = 3                    # tests/test_agg_tail.py's _data seed
TAIL_PARTITIONS = 16
# each tail query's kernels that its main path must launch
TAIL_KERNELS = {
    "grouped_first_last": ("segmented_pick", "gather", "gather_strings",
                           "sort"),
    "global_first_last": ("masked_pick", "gather", "gather_strings"),
    "grouped_max_min_by": ("segmented_pick", "segmented_extreme",
                           "gather_strings"),
    "grouped_by_string": ("segmented_pick", "gather_strings"),
    "global_by_string": ("masked_pick", "gather_strings"),
    "grouped_string_extremes": ("segmented_pick", "gather_strings"),
    "grouped_bits": ("segmented_bitwise", "sort"),
    "global_bits": ("masked_bitwise",),
}
# each output column of a tail query, as numpy evaluates it: (kind, value
# column, ordering column or ignore_nulls); MIN / MAX over a string is the
# string at its own extreme
TAIL_SPECS = {
    "grouped_first_last": [("first", "v", False), ("last", "v", False),
                           ("first", "v", True), ("last", "v", True),
                           ("first", "s", False), ("last", "s", True)],
    "global_first_last": [("first", "v", True), ("last", "x", False),
                          ("first", "s", False), ("last", "b", True)],
    "grouped_max_min_by": [("max", "v", "x"), ("min", "v", "x"),
                           ("max", "s", "v"), ("min", "s", "v")],
    "grouped_by_string": [("max", "v", "s"), ("min", "v", "s"),
                          ("max", "s", "s"), ("min", "x", "s")],
    "global_by_string": [("max", "v", "s"), ("min", "v", "s")],
    "grouped_string_extremes": [("min", "s", "s"), ("max", "s", "s")],
    "grouped_bits": [("bit_and", "v", None), ("bit_or", "v", None),
                     ("bit_xor", "v", None), ("bit_and", "b", None),
                     ("bit_xor", "b", None)],
    "global_bits": [(op, c, None) for c in "vb"
                    for op in ("bit_and", "bit_or", "bit_xor")],
}
_I64_MAX = np.iinfo(np.int64).max
_I64_MIN = np.iinfo(np.int64).min


class TailNumpy:
    """Independent evaluation of the tail queries over the host columns,
    in the port's input order (a partition's batches in turn, the
    partitions in order: ``create_dataframe`` deals the batches out
    round-robin): a group's rows stably sorted by key, then FIRST / LAST
    as the first / last eligible position, MAX_BY / MIN_BY as the first
    position of the valid extreme of an int64 order word (a double's
    bits, -0.0 as 0.0, NaN above +inf grouped and equal to it global, as
    the reference orders it; a string's code through ``held.TAIL_RANK``),
    the bit aggregates by ``np.bitwise_*.reduceat``."""

    def __init__(self, data, validity, nbatches: int, batch_rows: int,
                 parts: int):
        self.data, self.validity = data, validity
        n = len(data["k"])
        order = np.concatenate([
            np.arange(i * batch_rows, min((i + 1) * batch_rows, n))
            for p in range(parts) for i in range(p, nbatches, parts)])
        self.global_idx = order
        self.grouped_idx = order[np.argsort(data["k"][order], kind="stable")]
        sk = data["k"][self.grouped_idx]
        self.starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
        self.keys = sk[self.starts].tolist()

    def key_word(self, c: str, idx, grouped: bool) -> np.ndarray:
        x = self.data[c][idx]
        if c == "s":
            return held.TAIL_RANK[x.astype(np.int64)]
        if x.dtype.kind != "f":
            return x.astype(np.int64)
        nan = np.isnan(x)
        y = np.where(nan, np.inf, np.where(x == 0, 0.0, x))
        b = y.view(np.int64)
        w = np.where(b < 0, b ^ 0x7FFFFFFFFFFFFFFF, b)
        return np.where(nan, _I64_MAX, w) if grouped else w

    def value(self, c: str, row) -> object:
        if row is None or not self.validity[c][row]:
            return None
        v = self.data[c][row]
        return held.TAIL_STRINGS[int(v)] if c == "s" else v.item()

    def column(self, spec, grouped: bool) -> list:
        kind, c, arg = spec
        idx = self.grouped_idx if grouped else self.global_idx
        starts = self.starts if grouped else np.zeros(1, np.int64)
        n = len(idx)
        pos = np.arange(n)
        if kind.startswith("bit_"):
            x = self.data[c][idx]
            ok = self.validity[c][idx]
            ident = x.dtype.type(-1 if kind == "bit_and" else 0)
            ufunc = {"bit_and": np.bitwise_and, "bit_or": np.bitwise_or,
                     "bit_xor": np.bitwise_xor}[kind]
            red = ufunc.reduceat(np.where(ok, x, ident), starts)
            cnt = np.add.reduceat(ok, starts, dtype=np.int64)
            return [r.item() if k else None for r, k in zip(red, cnt)]
        if kind in ("first", "last"):
            eligible = self.validity[c][idx] if arg else np.ones(n, bool)
        else:
            ok = self.validity[arg][idx]
            w = self.key_word(arg, idx, grouped)
            is_min = kind == "min"
            ident = _I64_MAX if is_min else _I64_MIN
            ufunc = np.minimum if is_min else np.maximum
            best = ufunc.reduceat(np.where(ok, w, ident), starts)
            lens = np.diff(np.r_[starts, n])
            eligible = ok & (w == np.repeat(best, lens))
        if kind == "last":
            at = np.maximum.reduceat(np.where(eligible, pos, -1), starts)
        else:
            at = np.minimum.reduceat(np.where(eligible, pos, n), starts)
        return [self.value(c, idx[a]) if 0 <= a < n else None for a in at]

    def rows(self, name: str) -> list:
        grouped = name.startswith("grouped")
        cols = [self.column(spec, grouped) for spec in TAIL_SPECS[name]]
        rows = [tuple(col[i] for col in cols) for i in range(len(cols[0]))]
        if grouped:
            rows = [(k, *r) for k, r in zip(self.keys, rows)]
        return rows


def phase_tail_data(dev):
    """The aggregate tail's table on the card: tests/test_agg_tail.py's
    _data drawn at 15,003,037 rows, batches of 1,048,576, 16 partitions;
    numpy's results of the eight queries."""
    t0 = time.perf_counter()
    data, validity = held.tail_columns(TAIL_ROWS, TAIL_SEED)
    batches = held.tail_batches(data, validity, dev, N)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    ref = TailNumpy(data, validity, len(batches), N, TAIL_PARTITIONS)
    with ThreadPoolExecutor(4) as pool:
        want = dict(zip(held.TAIL_QUERIES, pool.map(
            ref.rows, held.TAIL_QUERIES)))
    resident = sum(t.nbytes for b in batches for c in b.columns
                   for t in (c.data, c.validity)
                   + ((c.offsets,) if c.is_string else ()))
    emit({"phase": "tail_data", "rows": TAIL_ROWS, "batches": len(batches),
          "partitions": TAIL_PARTITIONS, "resident_bytes": resident,
          "draw_and_upload_seconds": upload,
          "setup_seconds": time.perf_counter() - t0})
    df = GpuSession().create_dataframe(batches,
                                       num_partitions=TAIL_PARTITIONS)
    return df, want


def tail_equal(a, b) -> bool:
    """Exact: floats bit for bit (NaN equal to NaN, -0.0 apart from
    0.0)."""
    if a is None or b is None:
        return a is None and b is None
    if isinstance(b, float):
        return isinstance(a, float) and (
            np.isnan(a) and np.isnan(b)
            or np.float64(a).view(np.int64) == np.float64(b).view(np.int64))
    return a == b


def phase_tail(df, want) -> dict:
    """Each tail query's main path (traced, its launches), held against
    numpy, then timed."""
    by_path = {}
    nbatches = -(-TAIL_ROWS // N)
    for name, build in held.TAIL_QUERIES.items():
        query = lambda _, build=build: build(df)  # noqa: E731
        path = f"tail_{name}"
        rows, plan, launches, first_wall, profile = run_phase_path(
            path, query, TAIL_KERNELS[name])
        rows = sorted(rows, key=lambda r: r[0])
        exp = want[name]
        require(len(rows) == len(exp),
                f"{path} gave {len(rows)} rows, numpy {len(exp)}")
        for g, w in zip(rows, exp):
            require(len(g) == len(w) and all(
                tail_equal(a, b) for a, b in zip(g, w)),
                f"{path} row {g} where numpy has {w}")
        timing = time_path(path, query, None, TAIL_ROWS, profile)
        emit({"phase": path, "rows": TAIL_ROWS, "groups": len(rows),
              "first_wall_s": first_wall, "first_row": rows[0],
              "activities_per_batch": per_batch(timing, nbatches),
              **timing})
        by_path[path] = launches
    return by_path


# -- phase 15 ----------------------------------------------------------------

# 8 batches of 1,048,576: at 16,777,216 rows the script took 739.0 s on
# an H100 80GB HBM3 at 700 W
DEC_ROWS = 1 << 23               # 8,388,608
DEC_SEED = 11                    # tests/test_decimal128.py's df seed
DEC_PARTITIONS = 8
DEC_SAMPLE = 100_000
# each held decimal query's kernels that its main path must launch
DEC_KERNELS = {
    "dec_add_sub": ("decimal128_binary",),
    "dec_mul": ("decimal128_binary",),
    "dec_mixed": ("decimal128_binary",),
    "dec_filter": ("decimal128_binary", "compaction_map", "gather"),
    "dec_casts": ("decimal128_binary", "decimal128_divide"),
    "dec_divide": ("decimal128_divide",),
    "dec_sum_grouped": ("segmented_sum128", "sort", "gather", "concat"),
    "dec_sum_global": ("masked_sum128",),
    "dec_overflow": ("decimal128_binary", "segmented_sum128"),
    "dec_avg": ("segmented_sum128", "decimal128_binary", "decimal128_divide"),
    "dec_min_max_grouped": ("segmented_extreme128", "gather"),
    "dec_min_max_global": ("masked_extreme128",),
}
_M32 = 0xFFFFFFFF


def exact_sums(x: np.ndarray, ok: np.ndarray, starts: np.ndarray) -> list:
    """Per run, the exact sum of the valid rows (int64 [n] or [n, 2]
    limbs) as Python ints: 32-bit limbs reduced in int64, joined after."""
    if x.ndim == 1:
        return [int(v) for v in np.add.reduceat(np.where(ok, x, 0), starts)]
    lo, hi = x[:, 0], x[:, 1]
    parts = [lo & _M32, (lo >> 32) & _M32, hi & _M32, hi >> 32]
    sums = [np.add.reduceat(np.where(ok, p, 0), starts) for p in parts]
    return [int(a) + (int(b) << 32) + (int(c) << 64) + (int(d) << 96)
            for a, b, c, d in zip(*sums)]


def exact_extremes(x: np.ndarray, ok: np.ndarray, starts: np.ndarray,
                   is_min: bool) -> list:
    """Per run, the smallest / largest valid two-limb value (signed high
    limb, unsigned low), or None."""
    lo, hi = x[:, 0], x[:, 1].astype(np.int64)
    ufunc = np.minimum if is_min else np.maximum
    i64 = np.iinfo(np.int64)
    mh = ufunc.reduceat(np.where(ok, hi, i64.max if is_min else i64.min),
                        starts)
    lens = np.diff(np.r_[starts, len(lo)])
    cand = ok & (hi == np.repeat(mh, lens))
    lou = lo.view(np.uint64)
    ml = ufunc.reduceat(np.where(cand, lou, np.uint64(2**64 - 1) if is_min
                                 else np.uint64(0)), starts)
    n = np.add.reduceat(ok, starts, dtype=np.int64)
    return [to_python(int(b), a) if c else None
            for a, b, c in zip(mh.tolist(), ml.tolist(), n.tolist())]


class DecimalNumpy:
    """Independent evaluation of the held decimal queries over the host
    limbs: sums, averages, extremes and counts exact (Python ints from
    int64 reductions over 32-bit limb planes, never float weights), per
    key in key order; each elementwise query's rows at a seeded sample
    of positions of its output, in the port's input order (a partition's
    batches in turn, the partitions in order), from Python ints."""

    def __init__(self, data, validity, nbatches: int, batch_rows: int,
                 parts: int):
        self.data, self.validity = data, validity
        n = len(data["k"])
        self.order = np.concatenate([
            np.arange(i * batch_rows, min((i + 1) * batch_rows, n))
            for p in range(parts) for i in range(p, nbatches, parts)])
        k = data["k"]
        self.gorder = np.argsort(k, kind="stable")
        sk = k[self.gorder]
        self.starts = np.flatnonzero(np.r_[True, sk[1:] != sk[:-1]])
        self.keys = sk[self.starts].tolist()
        self.counts = np.diff(np.r_[self.starts, n]).tolist()
        c = data["c"].copy()
        a = data["a"]
        # dec_filter's rows: a > c * 100 (c at a's scale), both valid
        c100 = c * 100
        hi_c = c100 >> 63
        gt = (a[:, 1] > hi_c) | ((a[:, 1] == hi_c) & (
            a[:, 0].view(np.uint64) > c100.view(np.uint64)))
        self.kept = self.order[(validity["a"] & gt)[self.order]]

    def grouped(self, c: str):
        return (self.data[c][self.gorder], self.validity[c][self.gorder])

    def agg_rows(self, name: str) -> list:
        st = self.starts
        if name == "dec_sum_grouped":
            cols = [exact_sums(*self.grouped(c), st) for c in "abc"]
            bounds = (10**35, 10**38, 10**22)
            cols = [[v if abs(v) < b else None for v in col]
                    for col, b in zip(cols, bounds)]
            return [(k, *v, n) for k, *v, n in zip(self.keys, *cols,
                                                   self.counts)]
        if name == "dec_sum_global":
            s = exact_sums(self.data["a"], self.validity["a"],
                           np.zeros(1, np.int64))[0]
            return [(s, len(self.data["k"]))]
        if name == "dec_overflow":
            return [(k, 0 if k == 0 else None) for k in self.keys]
        if name == "dec_avg":
            out = []
            sums = {c: exact_sums(*self.grouped(c), st) for c in "ac"}
            nv = {c: np.add.reduceat(self.grouped(c)[1], st).tolist()
                  for c in "ac"}
            for i, k in enumerate(self.keys):
                out.append((k, *(half_up_div(sums[c][i] * 10**4, nv[c][i])
                                 for c in "ca")))
            return out
        if name == "dec_min_max_grouped":
            x, ok = self.grouped("a")
            mn = exact_extremes(x, ok, st, True)
            mx = exact_extremes(x, ok, st, False)
            n = np.add.reduceat(ok, st, dtype=np.int64).tolist()
            return list(zip(self.keys, mn, mx, n))
        if name == "dec_min_max_global":
            z = np.zeros(1, np.int64)
            return [(exact_extremes(self.data["b"], self.validity["b"], z,
                                    True)[0],
                     exact_extremes(self.data["b"], self.validity["b"], z,
                                    False)[0])]
        raise KeyError(name)

    def value(self, c: str, i: int):
        if not self.validity[c][i]:
            return None
        v = self.data[c][i]
        return to_python(v[0], v[1]) if c in "ab" else int(v)

    def row(self, name: str, i: int) -> tuple:
        """The expected output row of input row i."""
        a, b, c, k = (self.value(x, i) for x in "abck")

        def fit(v, p):
            return v if v is not None and abs(v) < 10 ** p else None

        def opt(f, *xs):
            return None if any(x is None for x in xs) else f(*xs)

        if name == "dec_add_sub":
            return (fit(opt(lambda x, y: x + y * 100, a, b), 33),
                    fit(opt(lambda x, y: x - y * 100, a, b), 33), k)
        if name == "dec_mul":
            return (fit(opt(lambda x, y: x * y, a, c), 38), k)
        if name == "dec_mixed":
            return (fit(opt(lambda x, y: y * 100 + x, a, c), 26),)
        if name == "dec_filter":
            return (a, k)
        if name == "dec_casts":
            return (fit(opt(lambda x: x * 100, a), 30),
                    fit(opt(lambda x: half_up_div(x, 1000), a), 20),
                    fit(opt(lambda x: half_up_div(x, 100), a), 12),
                    c, opt(to_double_ref, a),
                    opt(lambda x: -(-x // 10**4) if x < 0 else x // 10**4,
                        a),
                    k * 1000)
        if name == "dec_divide":
            if a is None or c == 0:
                return (None, k)
            q = half_up_div(abs(a) * 10**13, abs(c))
            return (fit(-q if (a < 0) != (c < 0) else q, 38), k)
        raise KeyError(name)

    def sample(self, name: str, rng, rows: int) -> tuple:
        """(output positions, their input rows) of a seeded sample."""
        src = self.kept if name == "dec_filter" else self.order
        pos = np.sort(rng.choice(len(src), min(DEC_SAMPLE, len(src)),
                                 replace=False))
        return pos, src[pos]


def to_double_ref(x: int) -> float:
    """The reference's to_double(x) / 10.0**4 in IEEE doubles: |x|'s high
    and low words each rounded, one rounding in the sum."""
    m = abs(x)
    f = float(m >> 64) * 18446744073709551616.0 + float(m & (2**64 - 1))
    return (-f if x < 0 else f) / 10.0 ** 4


def phase_decimal_data(dev):
    """The held decimal table on the card: tests/test_decimal128.py's df
    drawn at 8,388,608 rows (numpy limb products), batches of
    1,048,576, 8 partitions."""
    t0 = time.perf_counter()
    data, validity = held.decimal_columns(DEC_ROWS, DEC_SEED)
    batches = held.decimal_batches(data, validity, dev, N)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    ref = DecimalNumpy(data, validity, len(batches), N, DEC_PARTITIONS)
    resident = sum(t.nbytes for b in batches for c in b.columns
                   for t in (c.data, c.validity))
    emit({"phase": "decimal_data", "rows": DEC_ROWS, "batches": len(batches),
          "partitions": DEC_PARTITIONS, "resident_bytes": resident,
          "draw_and_upload_seconds": upload,
          "setup_seconds": time.perf_counter() - t0})
    df = GpuSession().create_dataframe(batches,
                                       num_partitions=DEC_PARTITIONS)
    return df, ref


@contextlib.contextmanager
def plain_decimal():
    """decimal128_binary and decimal128_divide replaced by their plain
    versions (on the card), for one comparison run."""
    saved = DK.decimal128_binary, DK.decimal128_divide
    DK.decimal128_binary = DK.decimal128_binary_plain
    DK.decimal128_divide = DK.decimal128_divide_plain
    try:
        yield
    finally:
        DK.decimal128_binary, DK.decimal128_divide = saved


def run_batches(query) -> list:
    """A query run to its device batches, in output order."""
    return [b for part in GpuEngine().execute(query.physical_plan())
            for b in part]


def output_columns(batches) -> list:
    """Each output column, its batches concatenated, on the card."""
    return list(S.concat_batches_device(batches).columns) if batches else []


def cell(col: DeviceColumn, pos: np.ndarray) -> list:
    data = col.data[torch.from_numpy(pos).to(col.device)].cpu()
    ok = col.validity[torch.from_numpy(pos).to(col.device)].cpu().tolist()
    if col.is_two_limb:
        vals = [to_python(lo, hi) for lo, hi in data.tolist()]
    else:
        vals = data.tolist()
    return [v if m else None for v, m in zip(vals, ok)]


def time_rows_path(name: str, query, profile, runs: int = 3,
                   rows: int = DEC_ROWS) -> dict:
    """time_path for a query whose output is the table's size: the walls
    of ``runs`` runs to device batches (no host rows), and the traced
    main-path run's profile."""
    walls = []
    for _ in range(runs):
        t = time.perf_counter()
        run_batches(query())
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t)
    wall = statistics.median(walls)
    busy_ms, activities, by_name = profile or (None, None, {})
    idle = None if activities is None else 1.0 - busy_ms / (wall * 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    emit({"phase": f"{name}_profile", "device_busy_ms": busy_ms,
          "device_activities": activities, "idle_share": idle,
          "top_device_ms": top})
    return {"wall_s": wall, "wall_s_runs": walls,
            "rows_per_s": rows / wall, "device_busy_ms": busy_ms,
            "device_activities": activities, "idle_share": idle}


def run_rows_path(name: str, query, kernels) -> tuple:
    """run_phase_path for a query run to its device batches: the counts
    set to 0 just before, read just after."""
    _lib.reset_launch_counts()
    t = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        batches = run_batches(query())
        torch.cuda.synchronize()
    first_wall = time.perf_counter() - t
    launches = dict(_lib.LAUNCHES)
    emit({"phase": f"{name}_launches", "launches": launches})
    for k in kernels:
        require(launches.get(k, 0) > 0, f"{name} never launched {k}")
    by_name: dict = {}
    events = device_events(prof)
    for event, ms in events:
        by_name[event] = by_name.get(event, 0.0) + ms
    profile = (sum(by_name.values()), len(events), by_name) if events \
        else None
    return output_columns(batches), launches, first_wall, profile


def phase_decimal(df, ref: DecimalNumpy) -> dict:
    """Each held decimal query's main path (traced, its launches).  An
    elementwise query's output stays on the card: held bit for bit over
    the whole table against the same plan run with the plain versions of
    decimal128_binary and decimal128_divide, and against Python ints at
    100,000 seeded rows.  An aggregate's rows against numpy's exact
    integers.  Each timed."""
    by_path = {}
    nbatches = -(-DEC_ROWS // N)
    rng = np.random.RandomState(DEC_SEED)
    for name, build in held.DEC_ROW_QUERIES.items():
        path = f"held_{name}"
        query = lambda build=build: build(df)  # noqa: E731
        cols, launches, first_wall, profile = run_rows_path(
            path, query, DEC_KERNELS[name])
        with plain_decimal():
            plain_cols = output_columns(run_batches(query()))
        hold_rows = [p for g, w in zip(cols, plain_cols, strict=True)
                     for p in ((g.data, w.data), (g.validity, w.validity))]
        require(all(torch.equal(bits(g), bits(w)) for g, w in hold_rows),
                f"{path}: the kernels' output differs from the plain "
                "versions' over the table")
        pos, src = ref.sample(name, rng, cols[0].num_rows)
        got = list(zip(*(cell(c, pos) for c in cols)))
        for g, i in zip(got, src.tolist()):
            w = ref.row(name, i)
            require(g == w, f"{path} row {i}: {g} where Python has {w}")
        timing = time_rows_path(path, query, profile)
        emit({"phase": path, "rows": DEC_ROWS,
              "output_rows": cols[0].num_rows, "sampled": len(pos),
              "plain_equal": True, "first_wall_s": first_wall,
              "activities_per_batch": per_batch(timing, nbatches),
              **timing})
        by_path[path] = launches
    for name, build in held.DEC_AGG_QUERIES.items():
        query = lambda _, build=build: build(df)  # noqa: E731
        path = f"held_{name}"
        rows, plan, launches, first_wall, profile = run_phase_path(
            path, query, DEC_KERNELS[name])
        rows = sorted(tuple(unscaled(v) for v in r) for r in rows)
        want = ref.agg_rows(name)
        require(rows == want, f"{path} gave {rows} where numpy has {want}")
        timing = time_path(path, query, None, DEC_ROWS, profile)
        emit({"phase": path, "rows": DEC_ROWS, "groups": len(rows),
              "first_wall_s": first_wall, "first_row": [str(v) for v in
                                                        rows[0]],
              "activities_per_batch": per_batch(timing, nbatches),
              **timing})
        by_path[path] = launches
    return by_path


# -- phase 16 ----------------------------------------------------------------

# an eighth of SF10 lineitem's rows: at a quarter (15,003,037, the size
# of phases 12 and 13) the script took 775.1 s on an H100 80GB HBM3 at
# 700 W, numpy's check of the seven queries the most of phase 16's 45 s
WINDOW_ROWS = SF10_ROWS // 8     # 7,501,518
WINDOW_SEED = 2                  # tests/test_window.py's wdf seed
WINDOW_PARTITIONS = 16
F64_RTOL_WINDOW = 1e-9           # tests/test_queries.py's _eq_val
# each held window query's kernels that its main path must launch
WINDOW_KERNELS = {
    "window_ranks": ("window_layout", "sort", "partition", "gather"),
    "window_running": ("window_layout", "frame_sum_count", "frame_extreme"),
    "window_whole": ("window_layout", "frame_sum_count", "frame_extreme"),
    "window_offsets": ("window_layout", "gather_null_extend"),
    "window_rows": ("window_layout", "frame_sum_count", "frame_extreme"),
    "window_range": ("window_layout", "range_frame_bounds",
                     "frame_sum_count", "frame_extreme"),
    "window_global": ("window_layout", "sort"),
}
#: the columns of W5 that are float frame sums (compared within
#: F64_RTOL_WINDOW; every other value exactly)
WINDOW_APPROX = {"window_rows": ("w1",)}
_BIG = np.iinfo(np.int64).max


class WindowNumpy:
    """Independent evaluation of the held window queries over every row.
    Rows reach the window's sort in table order within each key: the 15
    batches are map partitions 0-14 (round-robin), the exchange delivers
    them in that order and keeps the rows' order inside a batch, and the
    sort is stable; so each key's rows are ordered by (t, i) (W7: all rows
    by (t, v nulls first, i)).  Ranks and frames come from that order by
    np.maximum.accumulate and reduceat, running extremes by
    np.minimum.accumulate per key, the ROWS frames (at most 7 rows) by
    shifted copies, the RANGE frames from per-(k, t) group statistics.
    Each expected column is (values, validity) indexed by ``i``."""

    def __init__(self, data, validity):
        n = len(data["i"])
        self.n = n
        self.data, self.validity = data, validity
        order = np.lexsort((data["i"], data["t"], data["k"]))
        self.order = order
        k, t = data["k"][order], data["t"][order]
        pos = np.arange(n)
        part = np.r_[True, k[1:] != k[:-1]]
        peer = part | np.r_[True, t[1:] != t[:-1]]
        self.starts = np.flatnonzero(part)
        self.ends = np.r_[self.starts[1:], n]
        seg = np.cumsum(part) - 1
        run = np.cumsum(peer) - 1
        self.seg_start = np.maximum.accumulate(np.where(part, pos, 0))
        self.seg_end = self.ends[seg]
        self.seg = seg
        self.run_id = run
        self.run_first = np.maximum.accumulate(np.where(peer, pos, 0))
        self.run_last = np.r_[np.flatnonzero(peer)[1:], n][run] - 1
        self.pos = pos

    def sorted(self, name):
        """A column in the window's order: (values, validity)."""
        return (self.data[name][self.order],
                self.validity[name][self.order])

    def by_i(self, vals, valid=None):
        out = np.empty_like(vals)
        out[self.order] = vals
        ok = np.ones(self.n, np.bool_)
        if valid is not None:
            ok[self.order] = valid
        return out, ok

    def _frame(self, vals, valid, lo, up, op):
        """Over inclusive sorted frames [lo, up] with prefix sums: op
        'sum' (exact int64 or float) or 'count'."""
        contrib = np.where(valid, vals, 0) if op == "sum" else \
            valid.astype(np.int64)
        p = np.r_[np.zeros(1, contrib.dtype), np.cumsum(contrib)]
        empty = up < lo
        return np.where(empty, 0, p[np.maximum(up, lo - 1) + 1] - p[lo])

    def _running_extreme(self, vals, valid, is_min):
        fill = (np.inf if is_min else -np.inf) if vals.dtype.kind == "f" \
            else (_BIG if is_min else -_BIG - 1)
        x = np.where(valid, vals, fill)
        acc = np.minimum.accumulate if is_min else np.maximum.accumulate
        out = np.empty_like(x)
        for a, b in zip(self.starts, self.ends):
            out[a:b] = acc(x[a:b])
        return out

    def _rows_frame(self, vals, valid, pre, fol, op):
        """A ROWS frame of at most a few rows by shifted copies: sum,
        count, min or max over the valid rows of [pos - pre, pos +
        fol]."""
        n = self.n
        if op in ("min", "max"):
            fill = (np.inf if op == "min" else -np.inf) \
                if vals.dtype.kind == "f" else \
                (_BIG if op == "min" else -_BIG - 1)
            acc = np.full(n, fill, vals.dtype)
        else:
            acc = np.zeros(n, vals.dtype)
        cnt = np.zeros(n, np.int64)
        for d in range(-pre, fol + 1):
            j = self.pos + d
            ok = (j >= self.seg_start) & (j < self.seg_end)
            x = np.zeros_like(vals)          # vals and valid d rows on
            shifted = np.zeros(n, np.bool_)
            if d >= 0:
                x[:n - d], shifted[:n - d] = vals[d:], valid[d:]
            else:
                x[-d:], shifted[-d:] = vals[:n + d], valid[:n + d]
            ok &= shifted
            if op == "min":
                acc = np.where(ok, np.minimum(acc, x), acc)
            elif op == "max":
                acc = np.where(ok, np.maximum(acc, x), acc)
            else:
                acc = acc + np.where(ok, x, 0)
            cnt += ok
        return acc, cnt

    def _group_stats(self):
        """Per (k, t): count, sum, min and max of the valid v (once)."""
        if not hasattr(self, "_stats"):
            k, t = self.data["k"], self.data["t"]
            v, ok = self.data["v"], self.validity["v"]
            g = (k.astype(np.int64) * 40 + t)[ok]
            size = held.WINDOW_KEYS * 40
            mn = np.full(size, _BIG)
            mx = np.full(size, -_BIG - 1)
            np.minimum.at(mn, g, v[ok])
            np.maximum.at(mx, g, v[ok])
            self._stats = tuple(a.reshape(held.WINDOW_KEYS, 40) for a in (
                np.bincount(g, minlength=size),
                np.rint(np.bincount(g, v[ok], size)).astype(np.int64),
                mn, mx))
        return self._stats

    def _range_tables(self, pre, fol):
        """Per (k, t): count, sum, min, max of the valid v over the rows
        of the key with t in [t - pre, t + fol] (None: unbounded)."""
        cnt, tot, mn, mx = self._group_stats()
        out = {f: np.zeros((held.WINDOW_KEYS, 40), np.int64)
               for f in ("cnt", "sum", "min", "max")}
        for t0 in range(40):
            a = 0 if pre is None else max(t0 - pre, 0)
            b = 39 if fol is None else min(t0 + fol, 39)
            if b < a:
                out["min"][:, t0], out["max"][:, t0] = _BIG, -_BIG - 1
                continue
            out["cnt"][:, t0] = cnt[:, a:b + 1].sum(1)
            out["sum"][:, t0] = tot[:, a:b + 1].sum(1)
            out["min"][:, t0] = mn[:, a:b + 1].min(1)
            out["max"][:, t0] = mx[:, a:b + 1].max(1)
        return out

    def expected(self, name) -> dict:
        """Output column -> (values, validity) by i."""
        n, p = self.n, self.pos
        v, vok = self.sorted("v")
        x, xok = self.sorted("x")
        st, en = self.seg_start, self.seg_end
        cnt = en - st
        out = {}
        if name == "window_ranks":
            rk = self.run_first - st
            bs, rem = cnt // 3, cnt % 3
            r = p - st
            thr = rem * (bs + 1)
            nt = np.where(bs == 0, r + 1, np.where(
                r < thr, r // np.maximum(bs + 1, 1) + 1,
                rem + (r - thr) // np.maximum(bs, 1) + 1))
            cols = {"rn": p - st + 1, "rk": rk + 1,
                    "drk": self.run_id - self.run_id[st] + 1,
                    "pr": np.where(cnt > 1, rk / np.maximum(cnt - 1.0, 1.0),
                                   0.0),
                    "cd": (self.run_last + 1 - st) / np.maximum(cnt, 1.0),
                    "nt": nt}
            return {c: self.by_i(a) for c, a in cols.items()}
        if name in ("window_running", "window_whole"):
            up = self.run_last if name == "window_running" else en - 1
            sv = self._frame(v, vok, st, up, "sum")
            cv = self._frame(v, vok, st, up, "count")
            cx = self._frame(x, xok, st, up, "count")
            if name == "window_running":
                mn = self._running_extreme(v, vok, True)[up]
                mx = self._running_extreme(x, xok, False)[up]
                out = {"sv": self.by_i(sv, cv > 0), "cv": self.by_i(cv),
                       "av": self.by_i(sv / np.maximum(cv, 1), cv > 0),
                       "mn": self.by_i(mn, cv > 0),
                       "mx": self.by_i(mx, cx > 0)}
            else:
                seg_min = np.minimum.reduceat(np.where(vok, v, _BIG),
                                              self.starts)[self.seg]
                seg_max = np.maximum.reduceat(np.where(xok, x, -np.inf),
                                              self.starts)[self.seg]
                out = {"sv": self.by_i(sv, cv > 0), "n": self.by_i(cnt),
                       "mn": self.by_i(seg_min, cv > 0),
                       "mx": self.by_i(seg_max, cx > 0),
                       "av": self.by_i(sv / np.maximum(cv, 1), cv > 0)}
            return out
        if name == "window_offsets":
            def at(j, ok):
                jj = np.clip(j, 0, n - 1)
                return self.by_i(np.where(ok & vok[jj], v[jj], 0),
                                 ok & vok[jj])
            return {"ld": at(p + 1, p + 1 < en), "lg": at(p - 2, p - 2 >= st),
                    "fv": at(st, st >= 0), "lv": at(en - 1, en > 0),
                    "nv": self.by_i(np.zeros(n, np.int64),
                                    np.zeros(n, np.bool_))}
        if name == "window_rows":
            for j, (fn, c, start, end) in enumerate(held.ROWS_FRAMES):
                if start is None:       # count(*) ROWS UNBOUNDED..CURRENT
                    out[f"w{j}"] = self.by_i(p - st + 1)
                    continue
                vals, ok = (v, vok) if c == "v" else (x, xok)
                if fn == "sum_":        # an exact int64 sum: by prefixes
                    lo = np.maximum(p + start, st)
                    up = np.minimum(p + end, en - 1)
                    k = self._frame(vals, ok, lo, up, "count")
                    acc = self._frame(vals, ok, lo, up, "sum")
                else:                   # floats and extremes: row by row
                    op = {"avg": "sum", "min_": "min", "max_": "max"}[fn]
                    acc, k = self._rows_frame(vals, ok, -start, end, op)
                if fn == "avg":
                    acc = acc / np.maximum(k, 1)
                out[f"w{j}"] = self.by_i(acc, k > 0)
            return out
        if name == "window_range":
            k, t = self.data["k"][self.order], self.data["t"][self.order]
            for j, (fn, c, start, end) in enumerate(held.RANGE_FRAMES):
                tab = self._range_tables(None if start is None else -start,
                                         end)
                kc = tab["cnt"][k, t]
                if fn == "count":
                    out[f"w{j}"] = self.by_i(kc)
                elif fn == "sum_":
                    out[f"w{j}"] = self.by_i(tab["sum"][k, t], kc > 0)
                elif fn == "avg":
                    out[f"w{j}"] = self.by_i(tab["sum"][k, t]
                                             / np.maximum(kc, 1), kc > 0)
                else:
                    f = "min" if fn == "min_" else "max"
                    out[f"w{j}"] = self.by_i(tab[f][k, t], kc > 0)
            return out
        # window_global: ROW_NUMBER over (t, v nulls first), no partition
        order = np.lexsort((self.data["i"], self.data["v"],
                            self.validity["v"], self.data["t"]))
        rn = np.empty(n, np.int64)
        rn[order] = np.arange(1, n + 1)
        return {"rn": (rn, np.ones(n, np.bool_))}


def window_output_equal(name: str, cols, names, want) -> float:
    """The port's output columns (on the card) against numpy's by i:
    validity exactly, values where valid exactly (floats bit for bit)
    except WINDOW_APPROX's, within F64_RTOL_WINDOW (abs 1e-12).  Returns
    the largest relative error of those."""
    host = {nm: c.data.cpu().numpy() for nm, c in zip(names, cols)}
    ok = {nm: c.validity.cpu().numpy() for nm, c in zip(names, cols)}
    i = host["i"]
    require(np.array_equal(np.sort(i), np.arange(len(i))),
            f"held_{name}: the output is not every row once")
    worst = 0.0
    for col, (wv, wok) in want.items():
        g, gok = host[col], ok[col]
        wv, wok = wv[i], wok[i]
        require(np.array_equal(gok, wok), f"held_{name} {col}: validity "
                f"differs at {np.flatnonzero(gok != wok)[:5]}")
        g, w = g[gok], wv[gok].astype(g.dtype)
        if col in WINDOW_APPROX.get(name, ()):
            err = np.abs(g - w)
            bad = err > F64_RTOL_WINDOW * np.abs(w) + 1e-12
            require(not bad.any(), f"held_{name} {col}: {g[bad][:3]} where "
                    f"numpy has {w[bad][:3]}")
            worst = max(worst, float((err / np.maximum(np.abs(w), 1e-300))
                                     .max()) if len(w) else 0.0)
        else:
            same = g.view(np.int64) == w.view(np.int64) \
                if g.dtype == np.float64 else g == w
            require(bool(same.all()), f"held_{name} {col}: "
                    f"{g[~same][:3]} where numpy has {w[~same][:3]}")
    return worst


@contextlib.contextmanager
def plain_window():
    """The four window kernels replaced by their plain versions (on the
    card), for one comparison run."""
    names = ("window_layout", "frame_sum_count", "range_frame_bounds",
             "frame_extreme")
    saved = {nm: getattr(WK, nm) for nm in names}
    for nm in names:
        setattr(WK, nm, getattr(WK, f"{nm}_plain"))
    try:
        yield
    finally:
        for nm, fn in saved.items():
            setattr(WK, nm, fn)


def phase_window_data(dev):
    """The held window table on the card: tests/test_window.py's wdf drawn
    at 7,501,518 rows with the row index i, batches of 1,048,576, 16
    partitions; numpy's evaluation of the seven queries, started in
    threads (futures by query)."""
    t0 = time.perf_counter()
    data, validity = held.window_columns(WINDOW_ROWS, WINDOW_SEED)
    batches = held.window_batches(data, validity, dev, N)
    torch.cuda.synchronize()
    upload = time.perf_counter() - t0
    ref = WindowNumpy(data, validity)
    # numpy's answers, in threads while the card runs the queries
    pool = ThreadPoolExecutor(4)
    want = {name: pool.submit(ref.expected, name)
            for name in held.WINDOW_QUERIES}
    pool.shutdown(wait=False)
    resident = sum(t.nbytes for b in batches for c in b.columns
                   for t in (c.data, c.validity))
    emit({"phase": "window_data", "rows": WINDOW_ROWS,
          "batches": len(batches), "partitions": WINDOW_PARTITIONS,
          "resident_bytes": resident, "draw_and_upload_seconds": upload,
          "setup_seconds": time.perf_counter() - t0})
    df = GpuSession().create_dataframe(batches,
                                       num_partitions=WINDOW_PARTITIONS)
    return df, want


def phase_window(df, want) -> dict:
    """Each held window query's main path (traced, its launches), run to
    its device batches: every row against numpy, and the whole output
    against the same plan run with the plain versions of the four window
    kernels (bit for bit but W5's float frame sums, within K2's
    tolerance); then timed."""
    by_path = {}
    nbatches = -(-WINDOW_ROWS // N)
    for name, build in held.WINDOW_QUERIES.items():
        path = f"held_{name}"
        query = lambda build=build: build(df)  # noqa: E731
        cols, launches, first_wall, profile = run_rows_path(
            path, query, WINDOW_KERNELS[name])
        names = query().schema.names
        t = time.perf_counter()
        worst = window_output_equal(name, cols, names, want[name].result())
        numpy_s = time.perf_counter() - t
        with plain_window():
            plain_cols = output_columns(run_batches(query()))
        for nm, g, w in zip(names, cols, plain_cols, strict=True):
            require(torch.equal(g.validity, w.validity),
                    f"{path} {nm}: validity differs from the plain run")
            if nm in WINDOW_APPROX.get(name, ()):
                err = (g.data - w.data).abs()
                require(bool((err <= 1e-12 * w.data.abs() + 1e-12)
                             [w.validity].all()),
                        f"{path} {nm}: differs from the plain run")
            else:
                require(torch.equal(bits(g.data), bits(w.data)),
                        f"{path} {nm}: differs from the plain run")
        timing = time_rows_path(path, query, profile, rows=WINDOW_ROWS)
        emit({"phase": path, "rows": WINDOW_ROWS,
              "output_rows": cols[0].num_rows, "max_rel_err": worst,
              "numpy_check_s": numpy_s, "plain_equal": True,
              "first_wall_s": first_wall,
              "activities_per_batch": per_batch(timing, nbatches),
              **timing})
        by_path[path] = launches
    return by_path


# -- phase 17 ----------------------------------------------------------------

Q98_KERNELS = GROUPED_KERNELS + ("window_layout", "frame_sum_count",
                                 "string_rows_equal_prev")


def phase_q98(dfs, ref: GauntletNumpy) -> dict:
    """TPC-DS q98 over the SF10 store_sales, item and date_dim of phase
    11 (the session of phase 7): its main path traced, with its launches;
    every row against numpy in order; timed."""
    query = lambda _: tpcds.q98(dfs["ss"], dfs["dd"], dfs["item"])  # noqa
    rows, plan, launches, first, prof = run_phase_path("q98", query,
                                                       Q98_KERNELS)
    want = ref.q98_rows()
    require(len(rows) == len(want), f"q98 gave {len(rows)} rows, numpy "
            f"{len(want)}")
    worst = 0.0
    for g, w in zip(rows, want):
        require(tuple(g[:4]) == w[:4], f"q98 row {g} where numpy has {w}")
        for a, b in zip(g[4:], w[4:], strict=True):
            err = abs(a - b) / abs(b)
            require(err <= F64_RTOL_GAUNTLET, f"q98: {a} against numpy {b} "
                    f"in {g}")
            worst = max(worst, err)
    timing = time_path("q98", query, None, SS_ROWS, prof)
    emit({"phase": "q98", "fact_rows": SS_ROWS, "rows": len(rows),
          "brands": len({r[3] for r in rows}), "first_run_s": first,
          "max_rel_err": worst, "first_rows": rows[:3], **timing})
    return {"q98": launches}


def main() -> None:
    phase_device()
    dev = torch.device("cuda", torch.cuda.current_device())
    phase_build()
    tables = q3_tables()
    dims = q72_dims()
    gauntlet = GauntletNumpy(tables, dims)
    summary = phase_kernels(dev, tables)
    dfs, q6_ref, q1_ref, q1d_ref, nbatches = phase_data(dev)
    by_path = {**phase_q6(dfs, q6_ref, nbatches),
               **phase_q1(dfs, q1_ref, nbatches),
               **phase_q1_decimal(dfs, q1d_ref, nbatches)}
    q25_ref = Q25Numpy(tables[2])
    q3_dfs, q3_want, ss_pool = phase_q3_data(dev, tables, q25_ref,
                                             gauntlet)
    time_substring_q19(dev, gauntlet, summary)
    by_path["q3"] = phase_q3(q3_dfs, q3_want)
    q72_ref = Q72Numpy(tables[0], tables[1], dims)
    q25_dfs, q25_want, q17_want, cs_batches, order_pool = phase_q25_data(
        dev, q3_dfs, ss_pool, q25_ref, tables, q72_ref, gauntlet)
    by_path["q25"] = phase_q25(q25_dfs, q25_want)
    by_path["q17"] = phase_q17(q25_dfs, q17_want)
    phase_fusion_ab(dfs, q3_dfs, q25_dfs)
    by_path["q72"] = phase_q72(*phase_q72_data(
        dev, cs_batches, order_pool, q72_ref, dims, q3_dfs))
    chan_dfs, item_df, dd_df, chan_ref = phase_channel_data(dev, tables)
    by_path["q14a"] = phase_q14a(chan_dfs, item_df, chan_ref)
    by_path["q5"] = phase_q5(chan_dfs, dd_df, chan_ref)
    by_path["semi_anti"] = phase_semi_anti(chan_dfs, item_df, dd_df, tables,
                                           chan_ref)
    gauntlet_dfs = phase_gauntlet_data(dev, q25_dfs, gauntlet)
    by_path.update(phase_gauntlet(gauntlet_dfs, gauntlet))
    by_path.update(phase_held(*phase_held_data(dev)))
    by_path.update(phase_tail(*phase_tail_data(dev)))
    by_path.update(phase_decimal(*phase_decimal_data(dev)))
    by_path.update(phase_window(*phase_window_data(dev)))
    by_path.update(phase_q98(gauntlet_dfs, gauntlet))
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        s = summary[name]
        counts = {p: launches.get(name, 0) for p, launches in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"spark_rapids_tpu_torch/{source}",
            "replaces": replaces, "launches": sum(counts.values()),
            "launches_by_path": counts,
            "max_abs_err": ERRS[name], "ms": s["ms"], "ms_from": s["ms_from"],
            "call_ms": s["call_ms"], "plain_ms": s["plain_ms"],
            "bound_ms": s["bound_ms"], "bound_by": s["bound_by"],
            "library_ms": s["library_ms"]})
    emit({"phase": "profiler", "traces_without_the_card": PROFILER_LOST})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
