"""The port's unstructured readers (``fields/mesh.py``,
``fields/unstructured.py``, ``utils/selafin.py``) against the JAX
package's on the repository's fixtures (``tests/data/*_synth.*``, which the
port's own writers in ``tools/synthetic_mesh.py`` reproduce byte for byte),
the four reference goldens, and the mesh path of ``chip_smoke.py`` at a
small size.

Tolerances: host tables (the lookup rasters, the neighbours, the packed
node rows, the regridded tables) are equal; the triangle lookup on the
device picks the same triangles and nodes and its barycentric weights are
held within ``WEIGHT_ATOL`` (weight units: float32 transforms on a plane of
degrees, measured equal); samples of the same float32 expressions within
``EXACT_ATOL`` (measured equal); the column gather against the JAX
package's whole-row blend within ``EXACT_ATOL``; the goldens at the bounds
of ``tests/test_reference_unstructured_values_parity.py`` (imported from
it); runs at the slice tolerance of ``tests/test_torch_oceandrift.py`` with
every status equal.
"""

import json
import os
import sys
from datetime import timedelta

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402
import test_reference_unstructured_values_parity as GOLD  # noqa: E402
from test_torch_oceandrift import _assert_close  # noqa: E402

from opendrift_tpu.fields import mesh as JM  # noqa: E402
from opendrift_tpu.fields import unstructured as JU  # noqa: E402
from opendrift_tpu.utils import selafin as jselafin  # noqa: E402
from opendrift_tpu_torch.fields import mesh as TM  # noqa: E402
from opendrift_tpu_torch.fields import unstructured as TU  # noqa: E402
from opendrift_tpu_torch.interop import device_state_from_numpy  # noqa
from opendrift_tpu_torch.tools import synthetic_mesh as SM  # noqa: E402
from opendrift_tpu_torch.utils import selafin  # noqa: E402

EXACT_ATOL = 1e-6
WEIGHT_ATOL = 1e-6
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "goldens")
KINDS = ("telemac", "schism", "shyfem", "fvcom")


def _golden(kind):
    d = np.load(os.path.join(GOLDENS, f"ref_traj_{kind}_values.npz"))
    return d, json.loads(str(d["config"]))


def _open(mod, kind, sampling="regrid", use_3d=None):
    """The fixture of ``kind`` through ``mod``'s reader, as the goldens
    open it (FVCOM without 3D in native sampling, which refuses it)."""
    _, cfg = _golden(kind)
    path = cfg["fixture"] if os.path.exists(cfg["fixture"]) else \
        os.path.join(DATA, os.path.basename(cfg["fixture"]))
    if kind == "telemac":
        return mod.TelemacReader(path, proj4=cfg["proj4"], sampling=sampling)
    if kind == "schism":
        return mod.SCHISMReader(path, proj4=cfg["proj4"], use_3d=True,
                                sampling=sampling)
    if kind == "shyfem":
        return mod.SHYFEMReader(path, sampling=sampling)
    if use_3d is None:
        use_3d = sampling == "regrid"
    return mod.FVCOMReader(path, proj4=cfg["proj4"], use_3d=use_3d,
                           sampling=sampling)


# --------------------------------------------------------- host parsers ---

def test_fixture_writers_reproduce_the_fixtures(tmp_path):
    """The port's copies of the fixture writers write the repository's
    fixtures byte for byte."""
    for writer, name in ((SM.make_telemac_3d, "telemac3d_synth.slf"),
                         (SM.make_shyfem, "shyfem_synth.nc"),
                         (SM.make_schism, "schism_synth.nc"),
                         (SM.make_fvcom, "fvcom_synth.nc")):
        path = str(tmp_path / name)
        writer(path)
        with open(path, "rb") as a, open(os.path.join(DATA, name),
                                         "rb") as b:
            assert a.read() == b.read(), name


def test_selafin_parse_equals_jax():
    path = os.path.join(DATA, "telemac3d_synth.slf")
    t, j = selafin.SelafinFile(path), jselafin.SelafinFile(path)
    for name in ("title", "variable_names", "variable_units", "iparam",
                 "date", "n_elements", "n_nodes", "nodes_per_element",
                 "times_seconds"):
        assert getattr(t, name) == getattr(j, name), name
    for name in ("connectivity", "x", "y"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name))
    for frame in range(len(j.times_seconds)):
        for var in range(len(j.variable_names)):
            np.testing.assert_array_equal(t.read_variable(var, frame),
                                          j.read_variable(var, frame))


# ------------------------------------------------------------ the mesh ----

def _synthetic_mesh(name):
    """(x, y, triangles) of meshes with exact ties: a regular grid (lookup
    centres on its edges and nodes), one with a hole, one with quads."""
    from scipy.spatial import Delaunay
    g = np.linspace(0.0, 1.0, 12)
    X, Y = np.meshgrid(g, g)
    x, y = X.ravel(), Y.ravel()
    tri = Delaunay(np.column_stack([x, y])).simplices
    if name == "regular":
        return x, y, tri
    if name == "hole":
        cent = np.column_stack([x, y])[tri].mean(axis=1)
        hole = (np.abs(cent[:, 0] - 0.5) < 0.2) & \
            (np.abs(cent[:, 1] - 0.5) < 0.2)
        return x, y, tri[~hole]
    i, j = np.meshgrid(np.arange(11), np.arange(11))
    a = (j * 12 + i).ravel()
    quads = np.stack([a, a + 1, a + 13, a + 12], axis=1)
    quads[::3, 3] = -1                      # some cells are triangles
    return x + 60.0, y * 0.5 + 60.0, quads


def _mesh_pair(case):
    if case in KINDS:
        r = _open(JU, case)
        x, y = r._node_lon, r._node_lat
        tri = getattr(r, "_mesh_triangles", None)
    else:
        x, y, tri = _synthetic_mesh(case)
    return JM.MeshSampler(x, y, triangles=tri), TM.MeshSampler(
        x, y, triangles=tri), (x, y)


MESH_CASES = KINDS + ("regular", "hole", "quads")


@pytest.mark.parametrize("case", MESH_CASES)
def test_mesh_tables_equal_jax(case):
    """The lookup rasters (raw and dilated), transforms, nodes and
    neighbours equal the JAX package's built with matplotlib's trapezoid
    map: the port's rasteriser resolves every shared cell centre (on an
    edge or a node) as the trapezoid map does, so no cell differs."""
    j, t, _ = _mesh_pair(case)
    assert (t.nx, t.ny, t.lx0, t.ly0, t.ldx, t.ldy) == \
        (j.nx, j.ny, j.lx0, j.ly0, j.ldx, j.ldy)
    np.testing.assert_array_equal(t.triangles, j.triangles)
    ja, ta = j.device_arrays(), t.device_arrays()
    assert set(ja) == set(ta)
    for k in ja:
        np.testing.assert_array_equal(ta[k], np.asarray(ja[k]), err_msg=k)


def test_neighbours_equal_jax_on_non_manifold_edges():
    """An edge shared by more than two triangles pairs them as the JAX
    package's dictionary walk does."""
    tris = np.array([[0, 1, 2], [1, 0, 3], [0, 1, 4], [2, 1, 5],
                     [5, 2, 1]])
    np.testing.assert_array_equal(TM.tri_neighbors(tris),
                                  JM.MeshSampler._tri_neighbors(tris))


def _query_points(x, y, n=800, seed=0):
    """Scattered points over the mesh's box and beyond it, the nodes
    themselves, edge midpoints and a NaN."""
    r = np.random.default_rng(seed)
    x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
    qx = r.uniform(x0 - 0.05 * (x1 - x0), x1 + 0.05 * (x1 - x0), n)
    qy = r.uniform(y0 - 0.05 * (y1 - y0), y1 + 0.05 * (y1 - y0), n)
    k = r.integers(0, len(x), 50)
    qx = np.concatenate([qx, x[k], 0.5 * (x[k] + x[k[::-1]]), [np.nan]])
    qy = np.concatenate([qy, y[k], 0.5 * (y[k] + y[k[::-1]]), [np.nan]])
    return qx.astype(np.float32), qy.astype(np.float32)


@pytest.mark.parametrize("case", MESH_CASES)
def test_locate_device_matches_jax(case):
    """Triangle, nodes, inside and valid equal the JAX package's; weights
    within WEIGHT_ATOL (NaN where NaN)."""
    j, t, (x, y) = _mesh_pair(case)
    qx, qy = _query_points(np.asarray(x), np.asarray(y))
    jo = j.locate_device(j.device_arrays(), jnp.asarray(qx),
                         jnp.asarray(qy))
    to = t.locate_device(torch.as_tensor(qx), torch.as_tensor(qy))
    jtid, jw, jn, jin, jval = (np.asarray(a) for a in jo)
    ttid, tw, tn, tin, tval = (a.numpy() for a in to)
    np.testing.assert_array_equal(tval, jval)
    np.testing.assert_array_equal(tin, jin)
    np.testing.assert_array_equal(ttid[tval], jtid[jval])
    np.testing.assert_array_equal(tn[tval], jn[jval])
    np.testing.assert_allclose(tw, jw, rtol=0, atol=WEIGHT_ATOL)
    assert tval.mean() > 0.5 and not tval[-1]


def test_locate_device_linear_exact_and_hole_is_land():
    """Barycentric sampling reproduces a linear node field, and the hole
    of a mesh with connectivity is outside the mesh (JAX package tests
    ``test_mesh_sampler_linear_exact`` / ``_hole_is_land``)."""
    r = np.random.default_rng(3)
    x = r.uniform(0, 2, 500)
    y = r.uniform(50, 51, 500)
    ms = TM.MeshSampler(x, y)
    qx = torch.as_tensor(r.uniform(0.3, 1.7, 200), dtype=torch.float32)
    qy = torch.as_tensor(r.uniform(50.2, 50.8, 200), dtype=torch.float32)
    _, w, nidx, _, valid = ms.locate_device(qx, qy)
    rows = torch.as_tensor((3.0 * x - 2.0 * y + 7.0)[:, None],
                           dtype=torch.float32)
    got = ms.blend_columns(rows, w, nidx, 0)
    assert bool(valid.all())
    assert float((got - (3.0 * qx - 2.0 * qy + 7.0)).abs().max()) < 1e-3
    x, y, tri = _synthetic_mesh("hole")
    inside = TM.MeshSampler(x, y, triangles=tri).locate_device(
        torch.tensor([0.5, 0.1, 0.9]), torch.tensor([0.5, 0.1, 0.9]))[3]
    assert inside.tolist() == [False, True, True]


# -------------------------------------------------- the node-row gather ---

def _native_pair(kind, variables=None, interval=3600.0):
    j, t = _open(JU, kind, "native"), _open(TU, kind, "native")
    for r in (j, t):
        r.set_run_epoch(r.times[0])
        r.prepare(interval_seconds=interval, variables=variables)
    end = j.times[0] + timedelta(seconds=interval)
    jstate = j.device_state(j.times[0], end)
    host = t.device_state(t.times[0], end)
    return j, t, jstate, host, device_state_from_numpy(host, "cpu")


def _positions(kind, n=600):
    d, _ = _golden(kind)
    return (d["lon"][0][:n].astype(np.float32),
            d["lat"][0][:n].astype(np.float32),
            d["z"][0][:n].astype(np.float32))


@pytest.mark.parametrize("kind", KINDS)
def test_column_gather_equals_whole_row_blend(kind):
    """Native sampling gathers each variable's columns only (2 frames x 2
    levels x 3 nodes); on the JAX package's own triangles and weights it
    equals the JAX package's ``combine_rows`` + ``_mesh_values``, and each
    ``blend_columns`` equals the same column of whole blended rows."""
    j, t, jstate, host, tstate = _native_pair(kind)
    np.testing.assert_array_equal(host["node_rows"],
                                  np.asarray(jstate["node_rows"]))
    lon, lat, z = _positions(kind)
    _, jw, jn, _, _ = j._mesh.locate_device(jstate, jnp.asarray(lon),
                                            jnp.asarray(lat))
    rows = j._mesh.combine_rows(jstate["node_rows"], jw, jn)
    want = [v for v in t._mesh_cols]
    w, nidx = torch.as_tensor(np.array(jw)), torch.as_tensor(np.array(jn))
    for trel in (0.0, 1234.0, 3600.0):
        jv = j._mesh_values(rows, jstate, jnp.float32(trel), want,
                            jnp.maximum(-jnp.asarray(z), 0.0))
        tv = t._mesh_values(tstate, np.float32(trel), w, nidx, want,
                            torch.clamp_min(-torch.as_tensor(z), 0.0))
        for v in want:
            np.testing.assert_allclose(tv[v].numpy(), np.asarray(jv[v]),
                                       rtol=0, atol=EXACT_ATOL, err_msg=v)
    rows_t = tstate["node_rows"]
    whole = (rows_t[nidx[:, 0].long()] * w[:, 0:1]
             + rows_t[nidx[:, 1].long()] * w[:, 1:2]
             + rows_t[nidx[:, 2].long()] * w[:, 2:3])
    for col in range(whole.shape[1]):
        assert torch.equal(t._mesh.blend_columns(rows_t, w, nidx, col),
                           whole[:, col])


@pytest.mark.parametrize("kind", ("schism", "telemac", "shyfem"))
def test_sample_profiles_match_jax(kind):
    j, t, jstate, _, tstate = _native_pair(kind)
    lon, lat, _ = _positions(kind, 200)
    zlevels = np.array([0.0, -1.0, -4.5, -10.0, -25.0, -60.0], np.float32)
    names = [v for v in t._mesh_cols] + ["land_binary_mask"]
    jv, jc = j.sample_profiles(jstate, names, jnp.float32(600.0),
                               jnp.asarray(lon), jnp.asarray(lat),
                               jnp.asarray(zlevels))
    tv, tc = t.sample_profiles(tstate, names, np.float32(600.0),
                               torch.as_tensor(lon), torch.as_tensor(lat),
                               zlevels)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    for v in names:
        assert tv[v].shape == (len(zlevels), len(lon))
        np.testing.assert_allclose(tv[v].numpy(), np.asarray(jv[v]),
                                   rtol=0, atol=EXACT_ATOL, err_msg=v)


# ------------------------------------------------------------ readers -----

@pytest.mark.parametrize("sampling", ["regrid", "native"])
@pytest.mark.parametrize("kind", KINDS)
def test_reader_samples_match_jax(kind, sampling):
    """Each reader in both samplings: its host state equals the JAX
    package's (bit for bit), and its samples at the golden's points (and a
    band beyond the mesh) within EXACT_ATOL with equal coverage."""
    import torch_nc_fixtures as F
    j, t = _open(JU, kind, sampling), _open(TU, kind, sampling)
    assert t.variables == j.variables and t.times == j.times
    jstate, host, tstate = F.prepare_pair(j, t, interval_seconds=7200.0)
    # the port's mesh tables go to the device once, outside the window's
    # state (test_mesh_tables_equal_jax holds them)
    F.assert_tables_equal(host, {k: v for k, v in jstate.items()
                                 if not k.startswith("mesh_")})
    lon, lat, z = _positions(kind)
    lon = np.concatenate([lon, lon[:50] + 0.5]).astype(np.float32)
    lat = np.concatenate([lat, lat[:50]]).astype(np.float32)
    z = np.concatenate([z, z[:50]]).astype(np.float32)
    names = [v for v in t.variables if v not in t._derived]
    for trel in (0.0, 1800.0, 7200.0):
        jv, jc, tv, tc = F.sample_pair(j, t, jstate, tstate, names, trel,
                                       lon, lat, z)
        np.testing.assert_array_equal(tc, jc)
        for v in names:
            np.testing.assert_allclose(tv[v][tc], jv[v][tc], rtol=0,
                                       atol=EXACT_ATOL, err_msg=v)


def test_fvcom_native_3d_raises_in_both():
    """Native FVCOM sampling with ``use_3d=True`` averages cell values onto
    nodes only for 1-D frames and raises in the JAX package; the port
    keeps that limit (ROADMAP C.4)."""
    for mod in (JU, TU):
        r = _open(mod, "fvcom", "native", use_3d=True)
        r.set_run_epoch(r.times[0])
        r.prepare(interval_seconds=3600.0)
        with pytest.raises(ValueError):
            r.device_state(r.times[0], r.times[0] + timedelta(hours=1))


@pytest.mark.parametrize("kind", KINDS)
def test_goldens_hold(kind):
    """The four reference goldens at the JAX package's bounds (regrid
    sampling as ``test_reference_unstructured_values_parity.py`` opens
    them, Telemac also native)."""
    d, cfg = _golden(kind)
    lon, lat, z = d["lon"][0], d["lat"][0], d["z"][0]
    bounds = {"telemac": GOLD.TELEMAC_BOUNDS, "shyfem": GOLD.SHYFEM_BOUNDS,
              "schism": GOLD.SCHISM_BOUNDS, "fvcom": GOLD.FVCOM_BOUNDS}[kind]
    modes = ("regrid", "native") if kind == "telemac" else ("regrid",)
    for mode in modes:
        r = _open(TU, kind, mode)
        for k, off in enumerate(cfg["offsets_s"]):
            when = r.times[0] + timedelta(seconds=off)
            out = r.sample_at(lon, lat, when, variables=cfg["variables"],
                              z=z, device="cpu")
            for v in cfg["variables"]:
                ref = d[f"{v}__t{k}"][0]
                ours = out[v]
                if kind == "shyfem":
                    both = np.isfinite(ref)
                    assert (z[~both] < -55.0 + 1e-6).all()
                    assert np.isfinite(ours).all() and both.sum() > 300
                else:
                    both = np.isfinite(ref) & np.isfinite(ours)
                    assert both.sum() >= 0.97 * len(lon), v
                dd = ours[both] - ref[both]
                rb, mb = bounds[v]
                assert float(np.sqrt((dd ** 2).mean())) < rb, (mode, v, k)
                assert float(np.abs(dd).max()) < mb, (mode, v, k)


# ------------------------------------------------------------- factory ----

def _write_ugrid(path):
    """A small FVCOM/UGRID file in lon/lat with a time axis."""
    from scipy.io import netcdf_file
    from scipy.spatial import Delaunay
    r = np.random.default_rng(7)
    lon, lat = r.uniform(4.0, 5.0, 200), r.uniform(60.0, 60.5, 200)
    tri = Delaunay(np.column_stack([lon, lat])).simplices
    f = netcdf_file(path, "w")
    f.createDimension("node", len(lon))
    f.createDimension("nele", len(tri))
    f.createDimension("three", 3)
    f.createDimension("time", 2)
    for name, dims, data in (("lon", ("node",), lon),
                             ("lat", ("node",), lat),
                             ("h", ("node",), 50.0 + 10.0 * (lon - 4.0))):
        f.createVariable(name, "d", dims)[:] = data
    f.createVariable("nv", "i", ("three", "nele"))[:] = tri.T + 1
    t = f.createVariable("time", "d", ("time",))
    t[:] = [0.0, 1.0]
    t.units = b"hours since 2020-01-01 00:00:00"
    cl = lon[tri].mean(axis=1)
    for name, data in (("u", 0.1 * (cl - 4.0)), ("v", 0.2 + 0.0 * cl)):
        f.createVariable(name, "d", ("time", "nele"))[:] = np.stack(
            [data, data])
    f.close()
    return path


def test_factory_opens_telemac_and_ugrid_as_jax(tmp_path):
    """``reader_from_url`` opens a Selafin file as a TelemacReader and a
    UGRID file as an FVCOMReader, as the JAX factory does."""
    from opendrift_tpu.fields import factory as jfactory
    from opendrift_tpu_torch.fields import factory as tfactory
    for path in (os.path.join(DATA, "telemac3d_synth.slf"),
                 _write_ugrid(str(tmp_path / "ugrid.nc"))):
        j, t = jfactory.reader_from_url(path), tfactory.reader_from_url(path)
        assert type(t).__name__ == type(j).__name__
        assert isinstance(t, (TU.TelemacReader, TU.FVCOMReader))
        assert t.variables == j.variables and t.times == j.times
        np.testing.assert_array_equal(t.x, j.x)
        np.testing.assert_array_equal(t.y, j.y)


# ----------------------------------------------------------- the slice ----

def _reader_run(pkg, kind, sampling, n=64):
    if pkg == "jax":
        from opendrift_tpu.models import OceanDrift
        o = OceanDrift(loglevel=40, seed=0)
        reader = _open(JU, kind, sampling)
    else:
        from opendrift_tpu_torch.models import OceanDrift
        o = OceanDrift(loglevel=40, device="cpu", seed=0)
        reader = _open(TU, kind, sampling)
    o.add_reader(reader)
    o.set_config("general:use_auto_landmask", False)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:horizontal_diffusivity", 2.0)
    lon, lat, z = _positions(kind, n)
    o.seed_elements(lon=lon, lat=lat, z=z, time=reader.times[0])
    o.run(duration=timedelta(hours=1), time_step=600,
          time_step_output=1800)
    return o


@pytest.mark.parametrize("sampling", ["regrid", "native"])
@pytest.mark.parametrize("kind", KINDS)
def test_reader_runs_match_jax(kind, sampling):
    """A short OceanDrift run (RK4, horizontal diffusion) on each reader
    in both samplings: every status equal, lon/lat/z at the slice
    tolerance."""
    oj, ot = _reader_run("jax", kind, sampling), \
        _reader_run("torch", kind, sampling)
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        _assert_close(ot.result[var].values, oj.result[var].values, var)


def _mesh_run(pkg, files, sampling, n=4096, intervals=2):
    """chip_smoke.mesh_simulation's set-up on the small files, through
    either package."""
    if pkg == "torch":
        o, _ = chip_smoke.mesh_simulation("cpu", n, files,
                                          sampling=sampling)
    else:
        from opendrift_tpu.models import OceanDrift
        from opendrift_tpu.fields.grib import GribReader
        ocean = JU.SCHISMReader(files["schism"], proj4=SM.UTM33,
                                use_3d=True, sampling=sampling,
                                name="schism")
        o = OceanDrift(loglevel=40, seed=0)
        o.add_reader([ocean, GribReader(files["ecmwf"], name="ecmwf")])
        o.set_config("drift:advection_scheme", "runge-kutta4")
        o.set_config("drift:vertical_mixing", True)
        o.set_config("vertical_mixing:diffusivitymodel",
                     "windspeed_Large1994")
        o.set_config("vertical_mixing:timestep", 60.0)
        o.set_config("drift:horizontal_diffusivity", 10.0)
        r = np.random.default_rng(1)
        o.seed_from_wkt(chip_smoke.COAST_WKT, time=ocean.times[0],
                        number=n, z=-r.uniform(0.0, 30.0, n))
    o.run(duration=timedelta(seconds=9000 * intervals), time_step=900,
          time_step_output=9000)
    return o


@pytest.fixture(scope="module")
def mesh_files(tmp_path_factory):
    return chip_smoke.write_mesh_files(str(tmp_path_factory.mktemp("mesh")),
                                       small=True)


@pytest.mark.parametrize("sampling", ["native", "regrid"])
def test_mesh_slice_matches_jax(mesh_files, sampling):
    """The mesh path's configuration on the small files (a SCHISM mesh over
    Lofoten with the raster's coast, 3D currents z-sliced, the GRIB2 wind,
    RK4, Visser mixing with Large1994, horizontal diffusion): every status
    equal, lon, lat and z within the slice tolerance; natively, elements
    strand on the mesh's coast and none active leaves the mesh."""
    oj, ot = _mesh_run("jax", mesh_files, sampling), \
        _mesh_run("torch", mesh_files, sampling)
    status = ot.result["status"].values
    np.testing.assert_array_equal(status, np.asarray(
        oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        err, ok = chip_smoke.agree(
            ot.result[var].values, oj.result[var].values,
            chip_smoke.SLICE_MEDIAN_ATOL[var],
            chip_smoke.SLICE_OUTLIER_ATOL[var],
            chip_smoke.SLICE_OUTLIER_SHARE)
        assert ok, (var, err)
    if sampling == "native":
        chip_smoke.check_mesh_result(ot, 4096, 3, ot.env.readers["schism"])


def test_lofoten_mesh_has_the_raster_coast():
    """The smoke run's mesh writer: no triangle centroid on the raster's
    land, nodes renumbered densely, holes where the raster has islands."""
    from opendrift_tpu_torch.fields.landmask import GlobalLandmask
    from opendrift_tpu_torch.utils import crs as crslib
    x, y, tri, land = SM.lofoten_mesh(spacing_m=4000.0)
    assert tri.min() == 0 and tri.max() == len(x) - 1
    assert len(np.unique(tri)) == len(x)
    lon, lat = crslib.from_proj4(SM.UTM33).inv(np, x[tri].mean(axis=1),
                                                y[tri].mean(axis=1))
    assert not GlobalLandmask().contains(lon, lat).any()
    assert len(land) > 0.1 * len(tri)
