"""The Eulerian convection-diffusion solver of ``opendrift_tpu_torch``
(``models/eulerdrift.py``) on the CPU: the cases of
tests/test_eulerdrift.py run in both packages from the same inputs, and
the reference golden ``eulerdrift_field``.

Tolerances.  The stencil is the same float32 arithmetic in both packages,
but XLA fuses each step into one loop and may contract its multiply-adds:
fields are held to ``FIELD_RTOL`` of the field's maximum after up to 100
steps (9e-7 measured).  The golden keeps the JAX test's bounds (1e-5 on
the field, 1e-4 on its sum).
"""

import logging
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch.tools import parity_compare as parity

FIELD_RTOL = 1e-5


def _modules():
    from opendrift_tpu.models import eulerdrift as J
    from opendrift_tpu_torch.models import eulerdrift as T
    return J, T


def _sim(mod, pkg, **kw):
    if pkg == "torch":
        kw["device"] = "cpu"
    return mod.ExplSimulation.new(**kw)


def _field(sim):
    f = sim.grid.field
    return f.numpy() if torch.is_tensor(f) else np.asarray(f)


def _hold(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= FIELD_RTOL * np.abs(want).max()


def _blob_case(mod, pkg, case):
    """The runs of tests/test_eulerdrift.py; returns the simulation and
    what ``integrate`` returned."""
    if case == "diffusion":
        s = _sim(mod, pkg, lon0=10.0, lat0=65.0, res=20.0, shape=(96, 96),
                 D=5.0)
        s.grid.source_gaussian_blob(10.02, 65.01, A=1.0, N=15, sigma=60.0)
        return s, s.integrate(dt=5.0, max_steps=100)
    if case == "advection":
        s = _sim(mod, pkg, lon0=10.0, lat0=65.0, res=20.0, shape=(96, 96),
                 D=0.5)
        s.readers.append(lambda lons, lats, t: (
            np.full(lons.shape, 0.5, np.float32),
            np.zeros(lons.shape, np.float32)))
        s.grid.source_gaussian_blob(10.02, 65.01, A=1.0, N=15, sigma=60.0)
        return s, s.integrate(dt=10.0, max_steps=60)
    if case == "constant_reader":
        s = _sim(mod, pkg, lon0=5.0, lat0=60.0, res=10.0, shape=(80, 80),
                 D=0.05)
        s.readers.append(mod.ConstantReader.new_xy(x=0.5, y=0.0))
        lon_c, lat_c = s.grid.crs.inv(np, s.grid.x[40], s.grid.y[40])
        s.grid.source_gaussian_blob(float(lon_c), float(lat_c), A=1.0,
                                    N=11, sigma=30.0)
        return s, s.integrate(dt=2.0, max_steps=100)
    if case == "snapshots":
        s = _sim(mod, pkg, lon0=10.0, lat0=65.0, res=20.0, shape=(48, 48),
                 D=1.0)
        s.grid.source_gaussian_blob(10.02, 65.005, N=9, sigma=50.0)
        return s, s.integrate(dt=5.0, max_steps=20, store_every=5)
    if case == "edge_source":
        # a blob off the low edge lands at the high one, and a patch whose
        # corner lies outside the grid is moved inside, as
        # lax.dynamic_update_slice wraps a negative start, then clamps it
        s = _sim(mod, pkg, lon0=10.0, lat0=65.0, res=20.0, shape=(40, 40),
                 D=1.0)
        s.grid.source_gaussian_blob(10.0, 65.0, N=9, sigma=50.0)
        s.grid.source(10.02, 65.007, np.full((5, 7), 0.25, np.float32))
        return s, s.integrate(dt=5.0, max_steps=10)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["diffusion", "advection",
                                  "constant_reader", "snapshots",
                                  "edge_source"])
def test_runs_match_jax(case):
    J, T = _modules()
    sj, outj = _blob_case(J, "jax", case)
    st, outt = _blob_case(T, "torch", case)
    assert st.grid.field.dtype == torch.float32
    assert st.grid.field.device.type == "cpu"
    _hold(_field(st), _field(sj))
    assert st.t == sj.t
    assert st.grid.total_mass() == pytest.approx(sj.grid.total_mass(),
                                                 rel=1e-5)
    if case == "snapshots":
        cT, hist = outt
        assert hist.shape == (4, 48, 48)
        _hold(hist.numpy(), np.asarray(outj[1]))
        peaks = hist.numpy().max(axis=(1, 2))
        assert np.all(np.diff(peaks) < 0)      # monotone spreading
        assert torch.equal(cT, hist[-1])
    else:
        assert outt is st.grid.field
    f = _field(st)
    assert np.isfinite(f).all()
    if case in ("advection", "constant_reader"):
        cx = (f.sum(axis=0) * np.arange(f.shape[1])).sum() / f.sum()
        assert cx > f.shape[1] / 2 - 30


def test_grid_and_helpers_match_jax():
    J, T = _modules()
    gj = J.EulerGrid.new(10.0, 65.0, res=50.0, shape=(64, 64))
    gt = T.EulerGrid.new(10.0, 65.0, res=50.0, shape=(64, 64),
                         device="cpu")
    for a in ("x", "y", "lons", "lats"):
        np.testing.assert_array_equal(getattr(gt, a), getattr(gj, a))
    assert gt.field.shape == (64, 64)
    assert gt.contains(10.01, 65.005) and gj.contains(10.01, 65.005)
    assert gt.index_of(10.01, 65.005) == gj.index_of(10.01, 65.005)
    assert gt.center() == gj.center()
    assert T.utm_proj4(-70.0, -33.0) == J.utm_proj4(-70.0, -33.0)
    assert T.vec_nearest(np.array([0.0, 1.0, 2.0]), 1.2)[0] == 1
    f = np.zeros((9, 9))
    f[4, 4] = 1.0
    for a, b in zip(T.grad2d(f, 1.0, 1.0), J.grad2d(f, 1.0, 1.0)):
        np.testing.assert_array_equal(a, b)
    # the plot is ported: the field, brought to the host, as an image
    import matplotlib
    matplotlib.use("Agg")
    image = gt.plot().get_images()[0]
    np.testing.assert_array_equal(image.get_array(),
                                  gj.plot().get_images()[0].get_array())
    assert image.get_extent() == [gt.x[0], gt.x[-1], gt.y[0], gt.y[-1]]


def test_stability_warns_on_large_dt(caplog):
    _, T = _modules()
    s = T.ExplSimulation.new(10.0, 65.0, res=10.0, shape=(32, 32), D=2.0,
                             device="cpu")
    _, ddt = s.stability(1.0)
    assert ddt == pytest.approx(10.0 ** 2 / (2 * 2.0))
    s.grid.source_gaussian_blob(10.005, 65.002, N=9, sigma=30.0)
    with caplog.at_level(logging.WARNING,
                         logger="opendrift_tpu_torch.models.eulerdrift"):
        s.integrate(dt=ddt * 4, max_steps=2)
    assert any("dt too big" in r.message for r in caplog.records)


def test_opendrift_reader_wraps_a_port_reader():
    """``OpendriftReader`` samples one of the port's readers onto the
    grid on the grid's device, as the JAX package's wraps its own."""
    J, T = _modules()
    from opendrift_tpu.fields import ArrayReader as JArrayReader
    from opendrift_tpu_torch.fields import ArrayReader
    t0 = datetime(2021, 1, 1)
    ny = nx = 16
    r = np.random.default_rng(0)
    data = {"x_sea_water_velocity": r.uniform(-.5, .5, (2, ny, nx)).astype(
                np.float32),
            "y_sea_water_velocity": r.uniform(-.5, .5, (2, ny, nx)).astype(
                np.float32)}
    args = (np.linspace(4.0, 6.0, nx), np.linspace(59.5, 60.5, ny),
            [t0, t0 + timedelta(hours=6)])
    got_want = []
    for mod, reader, pkg in ((T, ArrayReader(data, *args), "torch"),
                             (J, JArrayReader(data, *args), "jax")):
        sim = _sim(mod, pkg, lon0=4.8, lat0=59.9, res=50.0, shape=(24, 24),
                   D=0.05, t0=t0)
        sim.readers.append(reader)          # wrapped on the fly
        got_want.append(sim._sample_uv(t0 + timedelta(hours=2)))
        sim.readers[0] = mod.OpendriftReader(reader)
        got_want.append(sim._sample_uv(t0 + timedelta(hours=2)))
    for a, b in zip(got_want[0] + got_want[1], got_want[2] + got_want[3]):
        assert a.shape == (24, 24)
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_eulerdrift_field_matches_reference():
    """The reference's ExplSimulation after 360 steps of constant
    advection and diffusion (the source patch placed in the reference's
    index space), cell for cell at the JAX test's 1e-5, through the port's
    parity tool."""
    rec = parity.check("eulerdrift_field", "cpu")
    assert rec["status"] == "pass", rec
