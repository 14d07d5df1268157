"""The port stands alone: no JAX, no import of the JAX package.

The scan reads the sources (an AST walk), because the interpreter may have
imported jax before any test runs, so sys.modules proves nothing.  Every
module imports without building or loading the CUDA kernels, and every
CUDA source is built.
"""
import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

from spark_rapids_tpu_torch.api.session import GpuSession
from spark_rapids_tpu_torch.kernels import _lib

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "spark_rapids_tpu")
PORT_FILES = sorted((ROOT / "spark_rapids_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
PORT_MODULES = [".".join(p.relative_to(ROOT).with_suffix("").parts)
                .removesuffix(".__init__") for p in PORT_FILES[:-1]]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", None)) in (
                    "__import__", "import_module") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_nothing_of_jax(path):
    bad = sorted({m for m in _imported_roots(path) if m in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_port():
    assert len(PORT_FILES) > 20
    assert "torch" in set(_imported_roots(ROOT / "chip_smoke.py"))


def test_session_defaults_to_the_card():
    if torch.cuda.is_available():
        assert GpuSession().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GpuSession()
    assert GpuSession(device="cpu").device == torch.device("cpu")


_IMPORT_PROBE = """
import importlib, json, sys
from spark_rapids_tpu_torch.kernels import _lib
loaded = {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    loaded[name] = _lib._lib is not None
print(json.dumps(loaded))
"""


@pytest.fixture(scope="module")
def kernels_loaded_by_import():
    """Import every port module, in order, in a fresh interpreter, and
    record after each whether the kernel library was loaded.  A fresh
    process, because a test that called a CUDA wrapper earlier in this one
    has loaded the library already."""
    out = subprocess.run([sys.executable, "-c", _IMPORT_PROBE,
                          *PORT_MODULES], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("name", PORT_MODULES)
def test_module_imports_without_building_kernels(name,
                                                 kernels_loaded_by_import):
    assert name in kernels_loaded_by_import
    assert not kernels_loaded_by_import[name], \
        f"importing {name} loaded the kernel library"


def test_every_cuda_source_is_built():
    assert sorted(_lib.SOURCES) == sorted(
        p.name for p in _lib.CSRC.glob("*.cu"))
    assert {"hash.cu", "sort.cu"} <= set(_lib.SOURCES)
    for name in ("spark_rapids_tpu_torch.kernels.hash",
                 "spark_rapids_tpu_torch.kernels.partition",
                 "spark_rapids_tpu_torch.kernels.sort",
                 "spark_rapids_tpu_torch.kernels.groupby",
                 "spark_rapids_tpu_torch.shuffle.transport"):
        assert name in PORT_MODULES


def test_q3_modules_and_sources_are_covered():
    """The q3 slice's modules are in the scans above, its CUDA sources are
    built, and the headers they share are in the library's content hash."""
    assert {"strings.cu", "join.cu"} <= set(_lib.SOURCES)
    assert sorted(_lib.HEADERS) == sorted(
        p.name for p in _lib.CSRC.glob("*.cuh"))
    for name in ("spark_rapids_tpu_torch.kernels.join",
                 "spark_rapids_tpu_torch.plan.execs.join",
                 "spark_rapids_tpu_torch.plan.execs.sort",
                 "spark_rapids_tpu_torch.testing.tpcds"):
        assert name in PORT_MODULES


def test_q72_modules_are_covered():
    """The q72 slice's modules (the conditional expression, the
    predicates, the join kernels and execs, the generators) are in the
    scans above and import nothing of JAX, and the conditional join's
    kernels are in a built source."""
    names = ("spark_rapids_tpu_torch.expressions.conditional",
             "spark_rapids_tpu_torch.expressions.predicates",
             "spark_rapids_tpu_torch.kernels.join",
             "spark_rapids_tpu_torch.kernels.selection",
             "spark_rapids_tpu_torch.plan.execs.join",
             "spark_rapids_tpu_torch.planner.optimizer",
             "spark_rapids_tpu_torch.testing.tpcds")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    source = (_lib.CSRC / "join.cu").read_text()
    assert "join.cu" in _lib.SOURCES
    for entry in ("srt_cond_join_count", "srt_cond_join_scatter"):
        assert entry in source and entry in _lib._SIGNATURES


def test_fused_segment_modules_are_covered():
    """The fused segment's modules (the lowering, the kernel's wrapper,
    the pass and its exec) are in the scans above and import nothing of
    JAX, and its kernel is in a built source with every entry point
    bound."""
    names = ("spark_rapids_tpu_torch.expressions.program",
             "spark_rapids_tpu_torch.kernels.fused",
             "spark_rapids_tpu_torch.plan.fused",
             "spark_rapids_tpu_torch.planner.overrides",
             "spark_rapids_tpu_torch.config")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    source = (_lib.CSRC / "fused.cu").read_text()
    assert "fused.cu" in _lib.SOURCES
    for entry in ("srt_fused_tile", "srt_fused_count", "srt_fused_write",
                  "srt_fused_global"):
        assert entry in source and entry in _lib._SIGNATURES


def test_q14a_q5_modules_are_covered():
    """The q14a and q5 slice's modules (the expand exec, the union and its
    planning, the session's union and rollup, the null literal, the semi
    and anti probes, the channel generators) are in the scans above and
    import nothing of JAX, and the semi and anti kernels' entry points are
    in a built source and bound."""
    names = ("spark_rapids_tpu_torch.plan.execs.misc",
             "spark_rapids_tpu_torch.plan.execs.basic",
             "spark_rapids_tpu_torch.plan.logical",
             "spark_rapids_tpu_torch.api.session",
             "spark_rapids_tpu_torch.expressions.core",
             "spark_rapids_tpu_torch.kernels.join",
             "spark_rapids_tpu_torch.planner.optimizer",
             "spark_rapids_tpu_torch.planner.overrides",
             "spark_rapids_tpu_torch.testing.tpcds")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    source = (_lib.CSRC / "join.cu").read_text()
    for entry in ("srt_join_probe", "srt_join_multi_probe",
                  "srt_join_expand_left_only"):
        assert entry in source and entry in _lib._SIGNATURES
    for kernel in ("join_expand_left_only_kernel", "kSemi", "kAnti"):
        assert kernel in source


def test_substring_slice_modules_are_covered():
    """The q19 slice's modules (SUBSTRING's expression and kernel wrapper,
    OR and NOT, the fused program's new instructions, the generators) are
    in the scans above and import nothing of JAX, and the substring
    kernel's entry points are in a built source and bound."""
    names = ("spark_rapids_tpu_torch.expressions.strings",
             "spark_rapids_tpu_torch.kernels.strings",
             "spark_rapids_tpu_torch.expressions.predicates",
             "spark_rapids_tpu_torch.expressions.program",
             "spark_rapids_tpu_torch.kernels.fused",
             "spark_rapids_tpu_torch.testing.tpcds")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    source = (_lib.CSRC / "strings.cu").read_text()
    assert "strings.cu" in _lib.SOURCES and "scan.cuh" in _lib.HEADERS
    assert "srt_substring_rows" in source
    assert "srt_substring_rows" in _lib._SIGNATURES
    assert "substring_rows_kernel" in source
    # the kept bytes are copied by the string gather's byte copy
    selection = (_lib.CSRC / "selection.cu").read_text()
    assert "idx != nullptr ? idx[r] : r" in selection
    wrapper = (ROOT / "spark_rapids_tpu_torch/kernels/strings.py").read_text()
    assert "srt_gather_bytes" in wrapper
    fused = (_lib.CSRC / "fused.cu").read_text()
    assert "IS_NULL, IF, OR, NOT" in fused


def test_aggregate_tail_modules_are_covered():
    """The MIN / MAX / M2 slice's modules (the aggregate functions and
    Divide, the wrappers, the grouped and global steps, the fused route,
    the q17 builder) are in the scans above and import nothing of JAX; the
    four kernels' entry points are in a built source and bound, and the
    DSL exports the new functions."""
    names = ("spark_rapids_tpu_torch.expressions.aggregates",
             "spark_rapids_tpu_torch.expressions.arithmetic",
             "spark_rapids_tpu_torch.expressions",
             "spark_rapids_tpu_torch.kernels.reduction",
             "spark_rapids_tpu_torch.kernels.groupby",
             "spark_rapids_tpu_torch.plan.execs.aggregate",
             "spark_rapids_tpu_torch.plan.fused",
             "spark_rapids_tpu_torch.types",
             "spark_rapids_tpu_torch.testing.tpcds")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        if not path.exists():
            path = ROOT / name.replace(".", "/") / "__init__.py"
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    source = (_lib.CSRC / "reduction.cu").read_text()
    assert "reduction.cu" in _lib.SOURCES
    for entry in ("srt_reduce_state_bytes", "srt_segmented_extreme",
                  "srt_masked_extreme", "srt_segmented_m2", "srt_masked_m2"):
        assert entry in source and entry in _lib._SIGNATURES
    from spark_rapids_tpu_torch import expressions as E
    for fn in ("min_", "max_", "var_samp", "var_pop", "stddev",
               "stddev_pop", "Divide", "BoolAnd", "BoolOr"):
        assert hasattr(E, fn) and fn in E.__all__
    from spark_rapids_tpu_torch.testing import tpcds
    assert callable(tpcds.q17)


def _meta(dtype, n=8):
    return torch.empty(n, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda R: R.segmented_extreme(_meta(torch.float64), _meta(torch.bool),
                                  _meta(torch.int32, 2), True),
    lambda R: R.masked_extreme(_meta(torch.int32), _meta(torch.bool), False),
    lambda R: R.segmented_m2("update", _meta(torch.int64), _meta(torch.bool),
                             _meta(torch.int32, 2), _meta(torch.float64, 2),
                             _meta(torch.int64, 2)),
    lambda R: R.segmented_m2("merge", _meta(torch.float64),
                             _meta(torch.bool), _meta(torch.int32, 2),
                             _meta(torch.float64, 2), _meta(torch.int64, 2),
                             _meta(torch.float64), _meta(torch.int64)),
    lambda R: R.masked_m2("update", _meta(torch.float32), _meta(torch.bool),
                          _meta(torch.float64, 1), _meta(torch.int64, 1)),
    lambda R: R.masked_m2("merge", _meta(torch.float64), _meta(torch.bool),
                          _meta(torch.float64, 1), _meta(torch.int64, 1),
                          _meta(torch.float64), _meta(torch.int64)),
], ids=["segmented_extreme", "masked_extreme", "segmented_m2_update",
        "segmented_m2_merge", "masked_m2_update", "masked_m2_merge"])
def test_new_wrappers_raise_off_the_cpu_without_cuda(call):
    """A tensor that is not on the CPU goes to the CUDA path, which raises
    for anything but a CUDA tensor (here: no card): no wrapper runs its
    plain version there, and nothing is counted as launched."""
    from spark_rapids_tpu_torch.kernels import reduction as R
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call(R)
    assert dict(_lib.LAUNCHES) == before


def test_pick_and_bitwise_slice_modules_are_covered():
    """The aggregate tail's modules (the types with BYTE and SHORT, the
    Arrow bridge, the wrappers, the group-by functions, the aggregates,
    the exec, the held table) are in the scans above and import nothing
    of JAX; the four kernels' entry points are in a built source and
    bound; the DSL exports the new functions."""
    names = ("spark_rapids_tpu_torch.kernels.reduction",
             "spark_rapids_tpu_torch.kernels.groupby",
             "spark_rapids_tpu_torch.expressions.aggregates",
             "spark_rapids_tpu_torch.plan.execs.aggregate",
             "spark_rapids_tpu_torch.columnar.arrow",
             "spark_rapids_tpu_torch.testing.held",
             "spark_rapids_tpu_torch.types")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    source = (_lib.CSRC / "reduction.cu").read_text()
    for entry in ("srt_segmented_pick", "srt_masked_pick",
                  "srt_segmented_bitwise", "srt_masked_bitwise"):
        assert entry in source and entry in _lib._SIGNATURES
    assert '#include "strings.cuh"' in source    # the string pick's chunks
    from spark_rapids_tpu_torch import expressions as E
    for fn in ("first", "last", "max_by", "min_by", "bit_and", "bit_or",
               "bit_xor", "First", "Last", "MaxBy", "MinBy"):
        assert hasattr(E, fn) and fn in E.__all__


@pytest.mark.parametrize("call", [
    lambda R: R.segmented_pick("first", _meta(torch.bool),
                               _meta(torch.int32, 2)),
    lambda R: R.segmented_pick("max", _meta(torch.bool),
                               _meta(torch.int32, 2), _meta(torch.int8)),
    lambda R: R.segmented_pick("min", _meta(torch.bool),
                               _meta(torch.int32, 2), _meta(torch.uint8, 20),
                               _meta(torch.int32, 9)),
    lambda R: R.masked_pick("last", _meta(torch.bool), ignore_nulls=True),
    lambda R: R.masked_pick("max", _meta(torch.bool), _meta(torch.float64)),
    lambda R: R.segmented_bitwise("bit_and", _meta(torch.int16),
                                  _meta(torch.bool), _meta(torch.int32, 2)),
    lambda R: R.masked_bitwise("bit_xor", _meta(torch.int64),
                               _meta(torch.bool)),
], ids=["segmented_pick_first", "segmented_pick_key", "segmented_pick_string",
        "masked_pick_last", "masked_pick_key", "segmented_bitwise",
        "masked_bitwise"])
def test_pick_and_bitwise_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_new_wrappers_raise_off_the_cpu_without_cuda``, for the
    four wrappers of the aggregate tail: no plain version off the CPU, no
    launch counted."""
    from spark_rapids_tpu_torch.kernels import reduction as R
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call(R)
    assert dict(_lib.LAUNCHES) == before


def test_decimal128_slice_modules_are_covered():
    """The Decimal128 slice's modules (the types, the column layout, the
    Arrow bridge, the gather and concat, the new wrappers, the
    expressions, the aggregates and their exec, the fused program's
    refusal, q1_decimal and the held decimal table) are in the scans above
    and import nothing of JAX; the four kernels' entry points are in a
    built source and bound, and the headers they share are in the
    library's content hash."""
    names = ("spark_rapids_tpu_torch.types",
             "spark_rapids_tpu_torch.columnar.column",
             "spark_rapids_tpu_torch.columnar.arrow",
             "spark_rapids_tpu_torch.kernels.selection",
             "spark_rapids_tpu_torch.kernels.decimal",
             "spark_rapids_tpu_torch.kernels.reduction",
             "spark_rapids_tpu_torch.expressions.arithmetic",
             "spark_rapids_tpu_torch.expressions.casts",
             "spark_rapids_tpu_torch.expressions.predicates",
             "spark_rapids_tpu_torch.expressions.aggregates",
             "spark_rapids_tpu_torch.expressions.program",
             "spark_rapids_tpu_torch.plan.execs.aggregate",
             "spark_rapids_tpu_torch.plan.fused",
             "spark_rapids_tpu_torch.testing.tpch",
             "spark_rapids_tpu_torch.testing.held")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    assert "decimal.cu" in _lib.SOURCES
    assert {"int128.cuh", "decimal.cuh"} <= set(_lib.HEADERS)
    for src, entries in (("decimal.cu", ("srt_decimal128_binary",
                                         "srt_decimal128_divide")),
                         ("reduction.cu", ("srt_segmented_sum128",
                                           "srt_masked_sum128",
                                           "srt_segmented_extreme128",
                                           "srt_masked_extreme128"))):
        source = (_lib.CSRC / src).read_text()
        assert '#include "int128.cuh"' in source or \
            '#include "decimal.cuh"' in source
        for entry in entries:
            assert entry in source and entry in _lib._SIGNATURES
    from spark_rapids_tpu_torch.testing import tpch
    assert callable(tpch.q1_decimal)


def _limbs(n=8):
    return torch.empty((n, 2), dtype=torch.int64, device="meta")


@pytest.mark.parametrize("call", [
    lambda D, R: D.decimal128_binary(D.ADD, _limbs(), _meta(torch.bool),
                                     _meta(torch.int64), _meta(torch.bool)),
    lambda D, R: D.decimal128_binary(D.TO_DOUBLE, _limbs(), _meta(torch.bool),
                                     ka=2),
    lambda D, R: D.decimal128_divide(_limbs(), _meta(torch.bool), _limbs(),
                                     _meta(torch.bool), 6),
    lambda D, R: D.decimal128_divide(_limbs(), _meta(torch.bool), 10 ** 20),
    lambda D, R: R.segmented_sum128(_limbs(), _meta(torch.bool),
                                    _meta(torch.int32, 2), 38,
                                    _meta(torch.int64)),
    lambda D, R: R.masked_sum128(_meta(torch.int64), _meta(torch.bool), 22),
    lambda D, R: R.segmented_extreme128(_limbs(), _meta(torch.bool),
                                        _meta(torch.int32, 2), True),
    lambda D, R: R.masked_extreme128(_limbs(), _meta(torch.bool), False),
], ids=["binary", "to_double", "divide", "divide_by_constant",
        "segmented_sum128", "masked_sum128", "segmented_extreme128",
        "masked_extreme128"])
def test_decimal128_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_pick_and_bitwise_wrappers_raise_off_the_cpu_without_cuda``,
    for the Decimal128 wrappers: no plain version off the CPU, no launch
    counted."""
    from spark_rapids_tpu_torch.kernels import decimal as D
    from spark_rapids_tpu_torch.kernels import reduction as R
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call(D, R)
    assert dict(_lib.LAUNCHES) == before


def test_window_slice_modules_are_covered():
    """The window slice's modules (the expressions, the Window node and
    its extraction, the planner's tag and conversion, the kernels'
    wrappers, the exec, the held window shapes and q98) are in the scans
    above and import nothing of JAX; the four kernels' entry points are
    in a built source and bound, and the DSL exports the window
    surface."""
    names = ("spark_rapids_tpu_torch.expressions.window",
             "spark_rapids_tpu_torch.plan.logical",
             "spark_rapids_tpu_torch.api.session",
             "spark_rapids_tpu_torch.planner.optimizer",
             "spark_rapids_tpu_torch.planner.overrides",
             "spark_rapids_tpu_torch.kernels.window",
             "spark_rapids_tpu_torch.plan.execs.window",
             "spark_rapids_tpu_torch.testing.held",
             "spark_rapids_tpu_torch.testing.tpcds")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    assert "window.cu" in _lib.SOURCES
    source = (_lib.CSRC / "window.cu").read_text()
    for entry in ("srt_window_layout", "srt_frame_sum",
                  "srt_range_frame_bounds", "srt_frame_extreme"):
        assert entry in source and entry in _lib._SIGNATURES
    from spark_rapids_tpu_torch import expressions as E
    for fn in ("over", "WindowFrame", "RowNumber", "Rank", "DenseRank",
               "PercentRank", "CumeDist", "Ntile", "Lead", "Lag",
               "FirstValue", "LastValue", "NthValue"):
        assert hasattr(E, fn) and fn in E.__all__
    from spark_rapids_tpu_torch.testing import held, tpcds
    assert callable(tpcds.q98) and len(held.WINDOW_QUERIES) == 7


@pytest.mark.parametrize("call", [
    lambda W: W.window_layout(_meta(torch.bool), _meta(torch.bool)),
    lambda W: W.frame_sum_count(_meta(torch.float64), _meta(torch.bool),
                                _meta(torch.int32), _meta(torch.int32),
                                _meta(torch.int32)),
    lambda W: W.frame_sum_count(_meta(torch.int64), _meta(torch.bool),
                                _meta(torch.int32), _meta(torch.int32),
                                _meta(torch.int32)),
    lambda W: W.range_frame_bounds(_meta(torch.int32), _meta(torch.int32),
                                   _meta(torch.int32), 5, None),
    lambda W: W.frame_extreme(_meta(torch.float64), _meta(torch.bool),
                              _meta(torch.int32), _meta(torch.int32), True),
], ids=["window_layout", "frame_sum_f64", "frame_sum_i64",
        "range_frame_bounds", "frame_extreme"])
def test_window_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_decimal128_wrappers_raise_off_the_cpu_without_cuda``, for
    the four window wrappers: no plain version off the CPU, no launch
    counted."""
    from spark_rapids_tpu_torch.kernels import window as W
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call(W)
    assert dict(_lib.LAUNCHES) == before


def test_memory_slice_modules_are_covered():
    """The memory runtime's modules (the arena, the spill framework, retry,
    the device manager, the copies of metrics, task completion and the
    checksums), the out-of-core helpers, the coalesce helpers, the range
    sort and the spillable shuffle store are in the scans above and import
    nothing of JAX; the router's and the order words' entry points are in
    a built source and bound, and the Decimal128 hash and join kinds are
    in theirs."""
    names = ("spark_rapids_tpu_torch.memory",
             "spark_rapids_tpu_torch.memory.arena",
             "spark_rapids_tpu_torch.memory.spill",
             "spark_rapids_tpu_torch.memory.retry",
             "spark_rapids_tpu_torch.memory.device_manager",
             "spark_rapids_tpu_torch.memory.metrics",
             "spark_rapids_tpu_torch.memory.task_completion",
             "spark_rapids_tpu_torch.utils.checksum",
             "spark_rapids_tpu_torch.plan.execs.out_of_core",
             "spark_rapids_tpu_torch.plan.execs.coalesce",
             "spark_rapids_tpu_torch.plan.execs.range_sort",
             "spark_rapids_tpu_torch.shuffle.transport",
             "spark_rapids_tpu_torch.kernels.partition",
             "spark_rapids_tpu_torch.kernels.sort",
             "spark_rapids_tpu_torch.kernels.hash",
             "spark_rapids_tpu_torch.kernels.join")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/")
                       + ("/__init__.py" if name.endswith("memory")
                          else ".py"))
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    source = (_lib.CSRC / "sort.cu").read_text()
    for entry in ("srt_order_words", "srt_range_route"):
        assert entry in source and entry in _lib._SIGNATURES
    assert "kDec128Hi" in source and "kDec128Lo" in source
    assert "kDec128" in (_lib.CSRC / "hash.cu").read_text()
    assert "kDec128" in (_lib.CSRC / "join.cu").read_text()


def _dec_meta(n=8):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    return DeviceColumn(_limbs(n), _meta(torch.bool, n), T.DecimalType(38, 2))


def _dec_meta_batch(n=8):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
    return ColumnarBatch((_dec_meta(n),), n,
                         Schema(("a",), (T.DecimalType(38, 2),)))


def _join_build_meta():
    from spark_rapids_tpu_torch.kernels import join as J
    return J._multi_build_cuda(
        [_dec_meta()], torch.empty(8, dtype=torch.int32, device="meta"))


@pytest.mark.parametrize("call", [
    lambda P, S, H: P.range_partition(
        torch.empty((3, 8), dtype=torch.int64, device="meta"),
        torch.empty((2, 3), dtype=torch.int64, device="meta"), 4),
    lambda P, S, H: S.sort_indices(_dec_meta_batch(), [0],
                                   [S.SortOrder(False)]),
    lambda P, S, H: S.order_words(_dec_meta(), S.SortOrder(True)),
    lambda P, S, H: H.murmur3_hash([_dec_meta()]),
    lambda P, S, H: H.murmur3_partition([_dec_meta()], 16),
    # a 226-byte string key's 31 words against 299 boundaries
    lambda P, S, H: P.range_partition(
        torch.empty((31, 8), dtype=torch.int64, device="meta"),
        torch.empty((299, 31), dtype=torch.int64, device="meta"), 300),
    lambda P, S, H: _join_build_meta(),
], ids=["range_partition", "decimal128_sort_key", "order_words",
        "decimal128_hash", "decimal128_hash_partition",
        "range_partition_long_key_300_partitions", "decimal128_join_key"])
def test_memory_slice_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_window_wrappers_raise_off_the_cpu_without_cuda``, for K1
    (the range router, also past the boundaries that fit in shared
    memory), K2 (the Decimal128 sort key, through the radix sort, the
    order words and the join's key words) and K3 (the Decimal128
    murmur3): no plain version off the CPU, no launch counted."""
    from spark_rapids_tpu_torch.kernels import hash as H
    from spark_rapids_tpu_torch.kernels import partition as P
    from spark_rapids_tpu_torch.kernels import sort as S
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call(P, S, H)
    assert dict(_lib.LAUNCHES) == before


def test_join_slice_modules_are_covered():
    """The right, full, cross and keyless joins (the join kernels, the
    join exec, the planner), the last key kinds (the sort, hash, join
    and reduction kernels) and the split-tolerant grouping (groupby, the
    aggregate exec) are in the scans above and import nothing of JAX; K1
    (the expand's flags), K2 (the cross expand) and K3 (the string hash
    key) are in their built sources and bound, and the BYTE and SHORT
    kinds are in each kernel's."""
    names = ("spark_rapids_tpu_torch.kernels.join",
             "spark_rapids_tpu_torch.kernels.sort",
             "spark_rapids_tpu_torch.kernels.hash",
             "spark_rapids_tpu_torch.kernels.groupby",
             "spark_rapids_tpu_torch.kernels.reduction",
             "spark_rapids_tpu_torch.plan.execs.join",
             "spark_rapids_tpu_torch.plan.execs.aggregate",
             "spark_rapids_tpu_torch.planner.overrides",
             "spark_rapids_tpu_torch.testing.held")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    join_cu = (_lib.CSRC / "join.cu").read_text()
    sort_cu = (_lib.CSRC / "sort.cu").read_text()
    for entry, source in (("srt_join_expand_cross", join_cu),
                          ("srt_join_expand", join_cu),
                          ("srt_string_hash_key", sort_cu)):
        assert entry in source and entry in _lib._SIGNATURES
    assert "matched" in join_cu and "accumulate_right" in join_cu
    for cu in ("join.cu", "sort.cu", "hash.cu"):
        text = (_lib.CSRC / cu).read_text()
        assert "kInt8" in text and "kInt16" in text, cu
    assert "Bounds<int8_t>" in (_lib.CSRC / "reduction.cu").read_text()


def _narrow_meta(dtype_name: str, n: int = 8):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    dt = getattr(T, dtype_name)
    return DeviceColumn(_meta(dt.torch_dtype, n), _meta(torch.bool, n), dt)


def _narrow_meta_batch(dtype_name: str, n: int = 8):
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
    c = _narrow_meta(dtype_name, n)
    return ColumnarBatch((c,), n, Schema(("k",), (c.dtype,)))


def _string_meta(n: int = 8):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    return DeviceColumn(_meta(torch.uint8, 4 * n), _meta(torch.bool, n),
                        T.STRING, _meta(torch.int32, n + 1))


def _string_meta_batch(n: int = 8):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch, Schema
    return ColumnarBatch((_string_meta(n),), n, Schema(("s",), (T.STRING,)))


def _outer_expand_meta():
    from spark_rapids_tpu_torch.kernels import join as J
    build = J.JoinBuild(_narrow_meta_batch("INT"), 0, _meta(torch.int32, 8),
                        _meta(torch.int64, 8), _meta(torch.bool, 8))
    return J.join_expand(_meta(torch.int32, 8), _meta(torch.int32, 9), 12,
                         build, "full", _meta(torch.bool, 8))


def _cond_accumulate_meta():
    from spark_rapids_tpu_torch.kernels import join as J
    i32, ok = _meta(torch.int32, 8), _meta(torch.bool, 8)
    return J.conditional_join_maps(i32, i32, ok, ok, ok, "right",
                                   rmatched=_meta(torch.bool, 8))


@pytest.mark.parametrize("call", [
    lambda J, S, H, R: _outer_expand_meta(),
    lambda J, S, H, R: J.cross_join_maps(4, 3, "meta"),
    lambda J, S, H, R: S.string_hash_key(_string_meta(), 2),
    lambda J, S, H, R: S.sort_indices(_string_meta_batch(), [0],
                                      [S.SortOrder()],
                                      hash_string_keys=True),
    lambda J, S, H, R: _cond_accumulate_meta(),
    lambda J, S, H, R: S.sort_indices(_narrow_meta_batch("BYTE"), [0],
                                      [S.SortOrder()]),
    lambda J, S, H, R: S.sort_indices(_narrow_meta_batch("SHORT"), [0],
                                      [S.SortOrder(False)]),
    lambda J, S, H, R: S.order_words(_narrow_meta("SHORT"), S.SortOrder()),
    lambda J, S, H, R: H.murmur3_hash([_narrow_meta("BYTE")]),
    lambda J, S, H, R: H.murmur3_partition([_narrow_meta("SHORT")], 16),
    lambda J, S, H, R: J.build_side(_narrow_meta_batch("BYTE"), 0),
    lambda J, S, H, R: R.segmented_extreme(
        _meta(torch.int8, 8), _meta(torch.bool, 8), _meta(torch.int32, 2),
        True),
    lambda J, S, H, R: R.masked_extreme(_meta(torch.int16, 8),
                                        _meta(torch.bool, 8), False),
], ids=["join_expand_outer", "join_expand_cross", "string_hash_key",
        "sort_hashed_string_key", "conditional_join_maps_accumulating",
        "sort_byte", "sort_short", "order_words_short", "murmur3_byte",
        "murmur3_partition_short", "join_build_byte",
        "segmented_extreme_int8", "masked_extreme_int16"])
def test_join_slice_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_memory_slice_wrappers_raise_off_the_cpu_without_cuda``,
    for K1 (the expand with a right or full join's flags), K2 (the cross
    join's pairs), K3 (the string hash key, alone and in the hashed
    sort), the accumulating conditional maps and the BYTE and SHORT
    kinds of the sort, the order words, murmur3, the join's build and
    the extremes: no plain version off the CPU, no launch counted."""
    from spark_rapids_tpu_torch.kernels import hash as H
    from spark_rapids_tpu_torch.kernels import join as J
    from spark_rapids_tpu_torch.kernels import reduction as R
    from spark_rapids_tpu_torch.kernels import sort as S
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call(J, S, H, R)
    assert dict(_lib.LAUNCHES) == before



def test_string_slice_modules_are_covered():
    """The string slice's modules (the regex engine's copy, the kernels'
    wrappers, the expressions, the conditionals, the planner's tags, the
    fused program's refusal, the held string table) are in the scans
    above and import nothing of JAX; K1-K4's entry points are in their
    built source and bound, each kernel has its own launch counter, and
    the DSL exports the string functions."""
    names = ("spark_rapids_tpu_torch.regex",
             "spark_rapids_tpu_torch.regex.parser",
             "spark_rapids_tpu_torch.regex.automata",
             "spark_rapids_tpu_torch.kernels.strings",
             "spark_rapids_tpu_torch.expressions.strings",
             "spark_rapids_tpu_torch.expressions.conditional",
             "spark_rapids_tpu_torch.expressions.program",
             "spark_rapids_tpu_torch.planner.overrides",
             "spark_rapids_tpu_torch.testing.held")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/")
                       + ("/__init__.py" if name.endswith("regex") else ".py"))
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    assert "string_functions.cu" in _lib.SOURCES
    source = (_lib.CSRC / "string_functions.cu").read_text()
    for entry in ("srt_string_row_scan", "srt_string_dfa_match",
                  "srt_string_assemble_count", "srt_string_assemble_write",
                  "srt_string_case_map"):
        assert entry in source and entry in _lib._SIGNATURES
    for kernel in ("row_scan_kernel", "dfa_match_kernel",
                   "assemble_count_kernel", "assemble_write_kernel",
                   "case_map_kernel",
                   "cudaFuncAttributeMaxDynamicSharedMemorySize"):
        assert kernel in source
    from spark_rapids_tpu_torch.kernels import strings as SS
    assert len({SS.ROW_SCAN, SS.DFA_MATCH, SS.ASSEMBLE, SS.CASE_MAP,
                SS.COUNTER}) == 5
    from spark_rapids_tpu_torch import expressions as E
    for fn in ("Length", "Upper", "Lower", "ConcatStrings", "StartsWith",
               "EndsWith", "Contains", "Like", "RLike", "Trim", "LTrim",
               "RTrim", "Reverse", "InitCap", "StringReplace", "StringLocate",
               "StringInstr", "Ascii", "StringRepeat", "Lpad", "Rpad",
               "ConcatWs", "Left", "Right", "OctetLength", "BitLength",
               "Translate", "Empty2Null", "Concat", "CaseWhen", "If"):
        assert hasattr(E, fn) and fn in E.__all__
    from spark_rapids_tpu_torch.testing import held
    assert len(held.STRING_QUERIES) == 6


def _dfa_meta():
    return (torch.empty((3, 256), dtype=torch.uint8, device="meta"),
            torch.empty(3, dtype=torch.uint8, device="meta"))


@pytest.mark.parametrize("call", [
    lambda S: S.char_length(_string_meta()),
    lambda S: S.contains_literal(_string_meta(), b"ab"),
    lambda S: S.startswith_literal(_string_meta(), b"a"),
    lambda S: S.endswith_literal(_string_meta(), b""),
    lambda S: S.first_occurrence_char(_string_meta(), b"a", 2),
    lambda S: S.trim_ws(_string_meta()),
    lambda S: S.ltrim_ws(_string_meta()),
    lambda S: S.rtrim_ws(_string_meta()),
    lambda S: S.dfa_match(_string_meta(), *_dfa_meta()),
    lambda S: S.concat_strings([_string_meta(), _string_meta()]),
    lambda S: S.concat_ws([_string_meta(), _string_meta()], b"-"),
    lambda S: S.select_strings(_meta(torch.int32),
                               [_string_meta(), _string_meta()]),
    lambda S: S.pad_chars(_string_meta(), 5, b"*", True),
    lambda S: S.repeat_string(_string_meta(), 3),
    lambda S: S.replace_literal(_string_meta(), b"a", b"bc"),
    lambda S: S.reverse_chars(_string_meta()),
    lambda S: S.translate_bytes(_string_meta(), *S._byte_tables("ab", "x")),
    lambda S: S.translate_bytes(_string_meta(), *S._byte_tables("ab", "xy")),
    lambda S: S.upper_ascii(_string_meta()),
    lambda S: S.lower_ascii(_string_meta()),
    lambda S: S.initcap_ascii(_string_meta()),
], ids=["char_length", "contains", "startswith", "endswith",
        "first_occurrence", "trim", "ltrim", "rtrim", "dfa_match",
        "concat", "concat_ws", "select", "pad", "repeat", "replace",
        "reverse", "translate_deleting", "translate_mapping", "upper",
        "lower", "initcap"])
def test_string_slice_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_join_slice_wrappers_raise_off_the_cpu_without_cuda``, for
    K1 (the row scan: LENGTH, the literal tests, LOCATE, the trims), K2
    (the DFA match), K3 (the assembly: each operation) and K4 (the case
    maps, TRANSLATE without deletions): no plain version off the CPU, no
    launch counted."""
    from spark_rapids_tpu_torch.kernels import strings as S
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call(S)
    assert dict(_lib.LAUNCHES) == before


def test_cast_slice_modules_are_covered():
    """The cast slice's modules (the string cast kernels' wrappers, the
    civil-date copy, the casts, the predicates, the planner's tag, the
    held cast table) are in the scans above and import nothing of JAX; C1
    and C2's entry points are in their built source and bound, each
    kernel has its own launch counter, and the DSL exports the new
    expressions."""
    names = ("spark_rapids_tpu_torch.kernels.cast_strings",
             "spark_rapids_tpu_torch.expressions.datetime",
             "spark_rapids_tpu_torch.expressions.casts",
             "spark_rapids_tpu_torch.expressions.predicates",
             "spark_rapids_tpu_torch.planner.overrides",
             "spark_rapids_tpu_torch.testing.held")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    assert "cast_strings.cu" in _lib.SOURCES
    source = (_lib.CSRC / "cast_strings.cu").read_text()
    for entry in ("srt_cast_pow10_load", "srt_string_parse",
                  "srt_string_format_count", "srt_string_format_write"):
        assert entry in source and entry in _lib._SIGNATURES
    for kernel in ("parse_kernel", "format_count_kernel",
                   "format_write_kernel", "__constant__ double kPow10",
                   '#include "scan.cuh"'):
        assert kernel in source
    code = "\n".join(line.split("//")[0] for line in source.splitlines())
    assert "pow(" not in code   # 10**e comes from the table
    from spark_rapids_tpu_torch.kernels import cast_strings as CS
    from spark_rapids_tpu_torch.kernels import strings as SS
    assert len({CS.PARSE, CS.FORMAT, SS.ROW_SCAN, SS.DFA_MATCH, SS.ASSEMBLE,
                SS.CASE_MAP, SS.COUNTER}) == 7
    from spark_rapids_tpu_torch import expressions as E
    for fn in ("Cast", "Coalesce", "EqualNullSafe", "In", "IsNotNull",
               "IsNull"):
        assert hasattr(E, fn) and fn in E.__all__
    for sugar in ("cast", "is_null", "is_not_null"):
        assert callable(getattr(E.col("x"), sugar))
    from spark_rapids_tpu_torch.testing import held
    assert len(held.CAST_QUERIES) == 4


@pytest.mark.parametrize("call", [
    lambda C: C.parse_integral(_string_meta()),
    lambda C: C.parse_double(_string_meta()),
    lambda C: C.parse_date(_string_meta()),
    lambda C: C.parse_bool(_string_meta()),
    lambda C: C.long_to_string(_meta(torch.int64), _meta(torch.bool)),
    lambda C: C.date_to_string(_meta(torch.int32), _meta(torch.bool)),
    lambda C: C.bool_to_string(_meta(torch.bool), _meta(torch.bool)),
], ids=["parse_integral", "parse_double", "parse_date", "parse_bool",
        "long_to_string", "date_to_string", "bool_to_string"])
def test_cast_slice_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_join_slice_wrappers_raise_off_the_cpu_without_cuda``, for
    C1 (``string_parse``: each parse) and C2 (``string_format``: each
    format): no plain version off the CPU, no launch counted."""
    from spark_rapids_tpu_torch.kernels import cast_strings as C
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call(C)
    assert dict(_lib.LAUNCHES) == before


def test_date_and_hash_slice_modules_are_covered():
    """The date and hash slice's modules (the time-zone kernels' wrappers,
    the hashes, the datetime, hashing, arithmetic and conditional
    expressions, the config's session zone, the held date table and the
    copied hash oracles) are in the scans above and import nothing of
    JAX; T1 / T2 (``csrc/timezone.cu``) and H1 / H2 (``csrc/hash.cu``) are
    in their built sources and bound, each kernel has its own launch
    counter, and the DSL exports the new expressions."""
    names = ("spark_rapids_tpu_torch.kernels.timezone",
             "spark_rapids_tpu_torch.kernels.hash",
             "spark_rapids_tpu_torch.expressions.datetime",
             "spark_rapids_tpu_torch.expressions.hashing",
             "spark_rapids_tpu_torch.expressions.arithmetic",
             "spark_rapids_tpu_torch.expressions.conditional",
             "spark_rapids_tpu_torch.config",
             "spark_rapids_tpu_torch.testing.held",
             "spark_rapids_tpu_torch.testing.hashes")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    assert "timezone.cu" in _lib.SOURCES
    sources = {name: (_lib.CSRC / name).read_text()
               for name in ("timezone.cu", "hash.cu")}
    for name, entries, kernels in (
            ("timezone.cu", ("srt_tz_max_entries", "srt_tz_shift"),
             ("tz_shift_kernel", "extern __shared__")),
            ("hash.cu", ("srt_xxhash64", "srt_hive_hash"),
             ("xxhash64_kernel", "hive_hash_kernel", "kF32"))):
        for entry in entries:
            assert entry in sources[name] and entry in _lib._SIGNATURES
        for kernel in kernels:
            assert kernel in sources[name]
    from spark_rapids_tpu_torch.kernels import hash as HK
    from spark_rapids_tpu_torch.kernels import timezone as TZ
    assert len({TZ.UTC_TO_LOCAL, TZ.LOCAL_TO_UTC, HK.XXHASH64,
                HK.HIVE_HASH, "murmur3"}) == 5
    from spark_rapids_tpu_torch import expressions as E
    for fn in ("Year", "Hour", "DateAdd", "MonthsBetween", "UnixSeconds",
               "FromUtcTimestamp", "ToUtcTimestamp", "XxHash64", "HiveHash",
               "Murmur3Hash", "IntegralDivide", "Remainder", "UnaryMinus",
               "Abs", "NullIf", "Nvl2", "Greatest", "Least", "hash",
               "xxhash64", "hive_hash", "from_utc_timestamp"):
        assert hasattr(E, fn) and fn in E.__all__
    x = E.col("x")
    assert type(x % 2).__name__ == "Remainder"
    assert type(-x).__name__ == "UnaryMinus"
    from spark_rapids_tpu_torch.testing import held
    assert len(held.DATE_QUERIES) == 9


def _micros_meta(n: int = 8):
    return _meta(torch.int64, n)


def _hash_meta_columns():
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    return [DeviceColumn(_meta(torch.int64), _meta(torch.bool), T.TIMESTAMP),
            DeviceColumn(_meta(torch.float32), _meta(torch.bool), T.FLOAT),
            _string_meta()]


@pytest.mark.parametrize("call", [
    lambda: __import__("spark_rapids_tpu_torch.kernels.timezone",
                       fromlist=["x"]).utc_to_local_micros(
        _micros_meta(), "America/Los_Angeles"),
    lambda: __import__("spark_rapids_tpu_torch.kernels.timezone",
                       fromlist=["x"]).local_to_utc_micros(
        _micros_meta(), "Asia/Kolkata"),
    lambda: __import__("spark_rapids_tpu_torch.kernels.hash",
                       fromlist=["x"]).xxhash64(_hash_meta_columns()),
    lambda: __import__("spark_rapids_tpu_torch.kernels.hash",
                       fromlist=["x"]).hive_hash(_hash_meta_columns()),
    lambda: __import__("spark_rapids_tpu_torch.kernels.hash",
                       fromlist=["x"]).murmur3_hash(_hash_meta_columns()),
], ids=["utc_to_local", "local_to_utc", "xxhash64", "hive_hash",
        "murmur3_float_timestamp"])
def test_date_and_hash_slice_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_cast_slice_wrappers_raise_off_the_cpu_without_cuda``, for
    T1 and T2 (the zone shifts), H1 (``xxhash64``), H2 (``hive_hash``) and
    murmur3's new FLOAT and TIMESTAMP kinds: no plain version off the
    CPU, no launch counted."""
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call()
    assert dict(_lib.LAUNCHES) == before


def test_sketch_slice_modules_are_covered():
    """The sketch slice's modules (the bloom and HLL wrappers, the
    round-robin partition, the range and exchange execs, the sketch
    expressions and the fixed-length array type) are in the scans above
    and import nothing of JAX; R1 (``csrc/sort.cu``), B1 / B2 and L1 / L2
    (``csrc/sketch.cu``) are in built sources and bound, the hashes they
    share are in ``csrc/hash.cuh`` (in the library's content hash), each
    kernel has its own launch counter, and the DSL exports the new
    expressions and calls."""
    names = ("spark_rapids_tpu_torch.kernels.bloom",
             "spark_rapids_tpu_torch.kernels.hll",
             "spark_rapids_tpu_torch.kernels.partition",
             "spark_rapids_tpu_torch.plan.execs.exchange",
             "spark_rapids_tpu_torch.plan.execs.misc",
             "spark_rapids_tpu_torch.expressions.hashing",
             "spark_rapids_tpu_torch.expressions.aggregates",
             "spark_rapids_tpu_torch.types")
    for name in names:
        assert name in PORT_MODULES
        path = ROOT / (name.replace(".", "/") + ".py")
        assert not {m for m in _imported_roots(path) if m in FORBIDDEN}
    assert "sketch.cu" in _lib.SOURCES and "hash.cuh" in _lib.HEADERS
    sources = {name: (_lib.CSRC / name).read_text()
               for name in ("sketch.cu", "sort.cu", "hash.cu", "hash.cuh",
                            "selection.cu")}
    for name, entries, kernels in (
            ("sketch.cu", ("srt_bloom_put", "srt_bloom_probe",
                           "srt_hll_max_registers", "srt_hll_global",
                           "srt_hll_grouped", "srt_hll_merge"),
             ("bloom_put_kernel", "bloom_probe_kernel", "hll_global_kernel",
              "hll_grouped_kernel", "hll_merge_kernel", '#include "hash.cuh"',
              "atomicOr", "__clzll")),
            ("sort.cu", ("srt_round_robin_order",),
             ("round_robin_order_kernel",))):
        for entry in entries:
            assert entry in sources[name] and entry in _lib._SIGNATURES
        for kernel in kernels:
            assert kernel in sources[name]
    # one copy of each device hash, in the shared header
    for fn in ("uint32_t hash_long(", "uint64_t xx_hash_long("):
        assert fn in sources["hash.cuh"] and fn not in sources["hash.cu"]
    assert '#include "hash.cuh"' in sources["hash.cu"]
    assert "move_wide_row" in sources["selection.cu"]
    from spark_rapids_tpu_torch.kernels import bloom as BK
    from spark_rapids_tpu_torch.kernels import hll as HL
    from spark_rapids_tpu_torch.kernels import partition as PK
    assert len({PK.ROUND_ROBIN, BK.BLOOM_PUT, BK.BLOOM_PROBE, HL.HLL_UPDATE,
                HL.HLL_MERGE, "partition", "gather"}) == 7
    from spark_rapids_tpu_torch import expressions as E
    for fn in ("BloomFilterMightContain", "ApproximateCountDistinct",
               "approx_count_distinct"):
        assert hasattr(E, fn) and fn in E.__all__
    from spark_rapids_tpu_torch.api.session import DataFrame, GpuSession
    for fn in ("repartition", "build_bloom", "collect_partitions"):
        assert callable(getattr(DataFrame, fn))
    assert callable(GpuSession.range)
    from spark_rapids_tpu_torch import types as T
    with pytest.raises(NotImplementedError, match="nested types"):
        T.ArrayType(T.IntegerType(), contains_null=False)
    with pytest.raises(NotImplementedError, match="nested types"):
        T.ArrayType(T.ByteType())
    assert T.row_shape(T.ArrayType(T.ByteType(), False, 512)) == (512,)


def _long_meta_column(n: int = 8):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    return DeviceColumn(_meta(torch.int64, n), _meta(torch.bool, n), T.LONG)


def _wide_meta_column(n: int = 8):
    from spark_rapids_tpu_torch import types as T
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    return DeviceColumn(torch.empty((n, 512), dtype=torch.int8,
                                    device="meta"), _meta(torch.bool, n),
                        T.ArrayType(T.ByteType(), False, 512))


@pytest.mark.parametrize("call", [
    lambda: __import__("spark_rapids_tpu_torch.kernels.partition",
                       fromlist=["x"]).round_robin_order(8, 3, 1, "meta"),
    lambda: __import__("spark_rapids_tpu_torch.kernels.bloom",
                       fromlist=["x"]).bloom_put(
        _meta(torch.int64, 4), _long_meta_column(), 3),
    lambda: __import__("spark_rapids_tpu_torch.kernels.bloom",
                       fromlist=["x"]).bloom_probe(
        _meta(torch.int64, 4), _long_meta_column(), 3),
    lambda: __import__("spark_rapids_tpu_torch.kernels.hll",
                       fromlist=["x"]).hll_update(_long_meta_column(), 9),
    lambda: __import__("spark_rapids_tpu_torch.kernels.hll",
                       fromlist=["x"]).hll_update(
        _long_meta_column(), 9, _meta(torch.int32, 2)),
    lambda: __import__("spark_rapids_tpu_torch.kernels.hll",
                       fromlist=["x"]).hll_merge(
        torch.empty((8, 512), dtype=torch.int8, device="meta"),
        _meta(torch.bool), _meta(torch.int32, 2)),
    lambda: __import__("spark_rapids_tpu_torch.kernels.selection",
                       fromlist=["x"]).gather_columns(
        [_wide_meta_column()], _meta(torch.int32, 4)),
    lambda: __import__("spark_rapids_tpu_torch.kernels.selection",
                       fromlist=["x"]).concat_column(
        [_wide_meta_column(), _wide_meta_column(3)]),
], ids=["round_robin_order", "bloom_put", "bloom_probe", "hll_global",
        "hll_grouped", "hll_merge", "gather_wide", "concat_wide"])
def test_sketch_slice_wrappers_raise_off_the_cpu_without_cuda(call):
    """As ``test_date_and_hash_slice_wrappers_raise_off_the_cpu_without_
    cuda``, for R1, B1, B2, L1 (global and grouped), L2 and the gather and
    concat of a wide row: no plain version off the CPU, no launch
    counted."""
    before = dict(_lib.LAUNCHES)
    with pytest.raises(ValueError, match="expected cuda"):
        call()
    assert dict(_lib.LAUNCHES) == before
