"""The port's golden-parity tool (``opendrift_tpu_torch/tools/
parity_compare.py``) against the JAX package's (``tools/parity_compare.py``)
and against the bounds of the JAX package's golden tests.

The tool keeps its own copies of those bounds; here they are held equal to
the tests' own: the trajectory tables by value, and the statistical bounds
of ``tests/test_reference_stat_parity.py`` as the set of numbers each test
holds a statistic to, read from the test's source.  Every scenario the
tool can run on the bundled data is run by the model test files
(``test_torch_{oceandrift,openoil,zoo,chemistry,landmask,eulerdrift}.py``);
here the command line runs two.
"""

import ast
import json
import os
import sys

import numpy as np
import pytest

TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(TESTS, "..", "tools"))

import parity_compare as jax_tool  # noqa: E402
import test_reference_trajectory_parity as TRAJ  # noqa: E402
from opendrift_tpu_torch.tools import parity_compare as tool  # noqa: E402

ORDERING = (ast.Lt, ast.Gt, ast.LtE, ast.GtE)


def _number(node):
    if isinstance(node, ast.Constant) and not isinstance(node.value, bool) \
            and isinstance(node.value, (int, float)):
        return float(node.value)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        v = _number(node.operand)
        return None if v is None else -v
    return None


def _stat_test_bounds(path):
    """{golden name: the numbers its test in ``path`` holds a statistic
    to}: the non-zero numbers an asserted ordering compares with, the
    ``atol``/``rtol`` of a ``numpy.testing`` assertion, and the bounds of
    the (name, bound) pairs a loop runs over."""
    with open(path) as f:
        tree = ast.parse(f.read())
    out = {}
    for fn in tree.body:
        if not (isinstance(fn, ast.FunctionDef)
                and fn.name.startswith("test_")):
            continue
        name, found = None, set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                callee = getattr(node.func, "id",
                                 getattr(node.func, "attr", ""))
                if callee in ("_load", "load_golden") and node.args:
                    name = node.args[0].value
                if callee.startswith("assert_"):
                    found.update(_number(kw.value) for kw in node.keywords
                                 if kw.arg in ("atol", "rtol"))
            if isinstance(node, ast.Assert):
                for cmp in ast.walk(node.test):
                    if isinstance(cmp, ast.Compare) and all(
                            isinstance(op, ORDERING) for op in cmp.ops):
                        found.update(v for v in map(
                            _number, (cmp.left, *cmp.comparators)) if v)
            if isinstance(node, ast.For) and isinstance(node.iter, ast.Tuple):
                found.update(_number(item.elts[1]) for item in node.iter.elts
                             if isinstance(item, ast.Tuple)
                             and len(item.elts) == 2)
        if name is not None:
            out[name] = found - {None}
    return out


def _tool_numbers(name):
    found = set()
    for v in tool.STAT_BOUNDS[name].values():
        found.update(float(x) for x in (v if isinstance(v, tuple) else (v,)))
    return found


def test_a_runner_for_every_scenario_of_the_jax_tool():
    assert set(tool.RUNNERS) == set(jax_tool.RUNNERS)
    assert tool.GOLDEN_ALIASES == jax_tool.GOLDEN_ALIASES
    for name in tool.RUNNERS:
        assert name in tool.TOLERANCES or name in tool.STAT_BOUNDS, name
    assert set(tool.SCENARIOS) == set(tool.TOLERANCES) | set(
        tool.STAT_BOUNDS)


def test_trajectory_bounds_equal_the_tests():
    assert tool.TOLERANCES == TRAJ.TOLERANCES
    assert tool.DZ_TOLERANCES == TRAJ.DZ_TOLERANCES
    assert tool.MEDIAN_TOLERANCES == TRAJ.MEDIAN_TOLERANCES


def test_statistical_bounds_equal_the_tests():
    tests = _stat_test_bounds(os.path.join(
        TESTS, "test_reference_stat_parity.py"))
    assert set(tests) == set(tool.STAT_BOUNDS)
    for name, numbers in tests.items():
        assert _tool_numbers(name) == numbers, name


def test_compare_equals_the_jax_tools_on_a_port_run():
    """The tool's ``compare`` (the port's geodesic inverse) against the
    JAX tool's on the same port run."""
    golden, cfg = tool.load_golden("constant_wind_euler")
    o = tool.RUNNERS["constant_wind_euler"](cfg, "cpu")
    got = tool.compare("constant_wind_euler", o, golden)
    want = jax_tool.compare("constant_wind_euler", o, golden)
    assert tuple(got["shape_ref"]) == tuple(want["shape_ref"])
    for k in ("max_m", "mean_m", "final_max_m", "final_mean_m",
              "final_median_m", "max_dz_m", "mean_dz_m"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-9, atol=1e-9,
                                   err_msg=k)


def test_cli_passes_two_scenarios_on_the_cpu(capsys):
    assert tool.main(["--device", "cpu", "double_gyre_rk4",
                      "plast_stat"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    assert [r["scenario"] for r in lines] == ["double_gyre_rk4",
                                              "plast_stat"]
    for rec in lines:
        assert rec["status"] == "pass" and rec["device"] == "cpu"
        assert rec["rows"] and all(r["ok"] for r in rec["rows"])


def test_absent_forcing_is_no_data_and_not_a_pass(tmp_path, capsys):
    assert tool.main(["--device", "cpu", "--data", str(tmp_path),
                      "arctic20_euler", "nordic_sigma_3d_euler_regrid"]) == 0
    lines = [json.loads(line) for line in
             capsys.readouterr().out.splitlines()]
    assert [r["status"] for r in lines] == ["no data", "no data"]
    assert lines[0]["file"] == os.path.join(
        str(tmp_path), "2Feb2016_Nordic_sigma_3d",
        "Arctic20_1to5Feb_2016.nc")


def test_a_scenario_beyond_its_bound_fails(monkeypatch, capsys):
    monkeypatch.setitem(tool.TOLERANCES, "windblow_euler", (1e-9, 1e-9))
    assert tool.main(["--device", "cpu", "windblow_euler"]) == 1
    rec = json.loads(capsys.readouterr().out)
    assert rec["status"] == "fail"
    assert [r["stat"] for r in rec["rows"] if not r["ok"]] == [
        "max_m", "final_mean_m"]


def test_unknown_scenario_is_refused():
    with pytest.raises(SystemExit):
        tool.main(["--device", "cpu", "no_such_scenario"])
