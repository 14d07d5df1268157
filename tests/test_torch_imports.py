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
