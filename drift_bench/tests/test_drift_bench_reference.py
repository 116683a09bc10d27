"""The plain reference against the program at a tiny size on the CPU:
its frozen draws and projections equal the program's, the program's
forecasts pass the check and the float16 control fails it."""

import numpy as np
import pytest
import torch

from drift_bench import check, control, run
from drift_bench.reference import draws, proj
from drift_bench.forcing import arome, norkyst
from drift_bench.tests.tiny import tiny_cell


def test_frozen_draws_equal_the_programs():
    from opendrift_tpu_torch import rng
    from opendrift_tpu_torch.ops import mixing
    seed = 2 ** 31 + 12345
    key, fkey = rng.PRNGKey(seed), draws.prng_key(seed)
    for d in (0, 1, 17, 987654):
        assert tuple(rng.fold_in(key, d)) == draws.fold_in(fkey, d)
    key, fkey = rng.fold_in(key, 3), draws.fold_in(fkey, 3)
    assert rng.bits(key) == draws.scalar_bits(fkey)
    n = 3001
    got = draws.normal_at(fkey, np.arange(2 * n).reshape(2, n))
    want = rng.normal(key, (2, n)).numpy()
    # log1p of numpy and torch may differ by an ulp: a few float32 ulp
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-7)
    ids = np.arange(1, n + 1)
    base = draws.walk_base(ids, rng.bits(key))
    tbase = mixing._element_base(torch.as_tensor(ids, dtype=torch.int32),
                                 rng.bits(key))
    for i in (0, 7, 14):
        np.testing.assert_array_equal(draws.walk_draw(base, i),
                                      mixing._draw(tbase, i).numpy())


@pytest.mark.parametrize("p", [norkyst.PROJ, arome.PROJ])
def test_projections_equal_the_programs(p):
    from opendrift_tpu_torch.utils import crs
    if p["proj"] == "stere":
        c = crs.from_proj4(f"+proj=stere +lat_0=90 +lon_0={p['lon_0']} "
                           f"+lat_ts={p['lat_ts']} +R={p['R']}")
    else:
        c = crs.from_proj4(f"+proj=lcc +lat_0={p['lat_0']} "
                           f"+lon_0={p['lon_0']} +lat_1={p['lat_1']} "
                           f"+lat_2={p['lat_1']} +R={p['R']}")
    lon = np.linspace(10.0, 18.0, 50)
    lat = np.linspace(66.5, 69.5, 50)
    x, y = proj.fwd(p, lon, lat)
    cx, cy = c.fwd(np, lon, lat)
    np.testing.assert_allclose(x, cx, rtol=0, atol=1e-6)
    np.testing.assert_allclose(y, cy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(proj.convergence(p, lon),
                               c.convergence(np, lon, lat), atol=1e-12)
    back = proj.inv(p, x, y)
    np.testing.assert_allclose(back, (lon, lat), atol=1e-9)


def _readings(variant, seed):
    cell = tiny_cell(elements=3000, hours=24, sample=1000)
    return cell, control.readings(cell, seed, run.Card("cpu"), variant,
                                  warm=False)


@pytest.mark.parametrize("seed", [11, 2 ** 33 + 5])
def test_the_program_passes_the_check(seed):
    cell, r = _readings("program", seed)
    assert r["failed"] == 0
    # the sample reaches the coast: the check compares stranding
    assert r["stranded_pct"] > 1.0
    ok, rows = check.verdict(cell.limits, r)
    assert ok, rows


def test_the_float16_control_fails_the_check():
    cell, r = _readings("float16", 11)
    ok, rows = check.verdict(cell.limits, r)
    assert not ok, rows
