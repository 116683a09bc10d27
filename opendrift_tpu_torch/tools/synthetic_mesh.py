"""Synthetic unstructured-model output files, written from numpy.

The port's own copies of the four deterministic fixture writers of the
repository's ``tools/unstructured_fixtures.py`` (the reference-parity
goldens and their fixtures in ``tests/data`` were made with them; the
writers are seeded and bit-stable, so a file written here equals the
fixture): :func:`make_telemac_3d`, :func:`make_shyfem`,
:func:`make_schism`, :func:`make_fvcom`, with their sample points and
analytic fields.

And a SCHISM native-output file at a regional model's width,
:func:`write_schism_lofoten`: a triangular mesh over Lofoten and
Vestfjorden in UTM 33N whose coastline and islands are those of the
bundled coastline raster (triangles with a centroid on land are dropped),
20 bottom-up levels with time-varying ``zcor``, ``hvel``, 3D ``temp`` and
``salt``, ``elev`` and ``depth``, float32.
"""

import struct

import numpy as np


# Lambert-North projection from the reference's own Telemac test
# (reference tests/readers/test_selafin.py:21-24)
TELEMAC_PROJ = ("+proj=lcc +lat_1=49.50000000000001 "
                "+lat_0=49.50000000000001 +lon_0=0 +k_0=0.999877341 "
                "+x_0=600000 +y_0=200000 +a=6378249.2 +b=6356515 "
                "+units=m +no_defs")


def _mesh2d(n_nodes=500, L=20000.0, x0=600000.0, y0=200000.0, seed=11):
    """Scattered 2D nodes in an LxL box + Delaunay triangulation."""
    rng = np.random.default_rng(seed)
    # jittered grid: irregular but well-conditioned triangles
    side = int(np.sqrt(n_nodes))
    gx, gy = np.meshgrid(np.linspace(0, L, side), np.linspace(0, L, side))
    x = (gx + rng.uniform(-0.3, 0.3, gx.shape) * L / side).ravel() + x0
    y = (gy + rng.uniform(-0.3, 0.3, gy.shape) * L / side).ravel() + y0
    from scipy.spatial import Delaunay
    tri = Delaunay(np.column_stack([x - x0, y - y0]))
    return x, y, tri.simplices


def _fields(x, y, plane_frac, t_sec, L=20000.0,
            x0=600000.0, y0=200000.0):
    """Analytic smooth fields: horizontal eddies + vertical shear +
    slow time evolution.  plane_frac: 0 at bottom .. 1 at surface.
    Normalisation is ABSOLUTE (box origin), so truth can be evaluated
    at arbitrary points."""
    xs = (x - x0) / L * 2 * np.pi
    ys = (y - y0) / L * 2 * np.pi
    amp = 1.0 + 0.25 * t_sec / 7200.0
    u = amp * (0.25 * np.sin(xs) * np.cos(ys) + 0.15 * plane_frac)
    v = amp * (-0.20 * np.cos(xs) * np.sin(ys) + 0.05 * plane_frac)
    w = 1e-4 * np.sin(xs + ys)
    temp = 6.0 + 4.0 * plane_frac + 0.5 * np.sin(xs) + 0.1 * amp
    salt = 35.0 - 1.5 * plane_frac - 0.2 * np.cos(ys)
    return u, v, w, temp, salt


def _depth(x, y, L=20000.0, x0=600000.0, y0=200000.0):
    xs = np.clip((x - x0) / L, 0.0, 1.0)
    ys = np.clip((y - y0) / L, 0.0, 1.0)
    return 30.0 + 60.0 * np.sin(np.pi * xs) * np.sin(np.pi * ys)


def make_telemac_3d(path, nplan=4):
    """3D Telemac Selafin file: NPLAN sigma planes (bottom-up), with
    ELEVATION Z so the reference reader's nearest-layer z selection
    works (reference reader_telemac_selafin.py:222-236)."""
    x2, y2, ikle2 = _mesh2d()
    npoin2 = len(x2)
    h = _depth(x2, y2)
    times = [0.0, 3600.0, 7200.0]
    names = ["VELOCITY U", "VELOCITY V", "VELOCITY W",
             "TEMPERATURE", "SALINITY", "ELEVATION Z"]
    units = ["M/S", "M/S", "M/S", "DEGREES C", "", "M"]

    def rec(payload):
        return (struct.pack(">i", len(payload)) + payload
                + struct.pack(">i", len(payload)))

    out = []
    out.append(rec(("SYNTHETIC TELEMAC 3D PARITY FIXTURE".ljust(72)
                    + "SERAFIN ").encode()))
    out.append(rec(struct.pack(">ii", len(names), 0)))
    for n, u in zip(names, units):
        out.append(rec((n.ljust(16) + u.ljust(16)).encode()))
    iparam = [1, 0, 0, 0, 0, 0, nplan, 0, 0, 1]
    out.append(rec(struct.pack(">10i", *iparam)))
    out.append(rec(struct.pack(">6i", 2021, 6, 1, 0, 0, 0)))
    # 3D mesh: prisms over the 2D triangulation
    nelem2 = len(ikle2)
    nelem3 = nelem2 * (nplan - 1)
    npoin3 = npoin2 * nplan
    out.append(rec(struct.pack(">4i", nelem3, npoin3, 6, 1)))
    ikle3 = np.zeros((nelem3, 6), np.int64)
    for p in range(nplan - 1):
        lower = ikle2 + p * npoin2
        upper = ikle2 + (p + 1) * npoin2
        ikle3[p * nelem2:(p + 1) * nelem2] = np.hstack([lower, upper])
    out.append(rec((ikle3 + 1).astype(">i4").tobytes()))
    out.append(rec(np.zeros(npoin3, ">i4").tobytes()))
    x3 = np.tile(x2, nplan)
    y3 = np.tile(y2, nplan)
    out.append(rec(x3.astype(">f4").tobytes()))
    out.append(rec(y3.astype(">f4").tobytes()))
    for t in times:
        out.append(rec(struct.pack(">f", t)))
        planes = []
        for p in range(nplan):
            frac = p / (nplan - 1)
            zp = -h * (1.0 - frac)          # bottom -h .. surface 0
            planes.append((frac, zp))
        for vi, name in enumerate(names):
            vals = np.empty(npoin3, np.float64)
            for p, (frac, zp) in enumerate(planes):
                u, v, w, temp, salt = _fields(x2, y2, frac, t)
                data = {"VELOCITY U": u, "VELOCITY V": v,
                        "VELOCITY W": w, "TEMPERATURE": temp,
                        "SALINITY": salt, "ELEVATION Z": zp}[name]
                vals[p * npoin2:(p + 1) * npoin2] = data
            out.append(rec(vals.astype(">f4").tobytes()))
    with open(path, "wb") as f:
        f.write(b"".join(out))
    return path


def sample_points(n=600, seed=5, L=20000.0, x0=600000.0, y0=200000.0):
    """Scattered sample positions inside the mesh interior (metres in
    the Telemac projection) + depths spanning the water column."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(x0 + 0.08 * L, x0 + 0.92 * L, n)
    y = rng.uniform(y0 + 0.08 * L, y0 + 0.92 * L, n)
    h = _depth(x, y)
    z = -rng.uniform(0.02, 0.95, n) * h
    return x, y, z


# geographic box for the SHYFEM fixture; mapped linearly onto the
# analytic-field box so truth can be evaluated at arbitrary lon/lat
SHYFEM_LON0, SHYFEM_LON1 = 12.5, 13.1
SHYFEM_LAT0, SHYFEM_LAT1 = 40.0, 40.45
SHYFEM_LEVELS = np.array([2.0, 10.0, 30.0, 80.0])   # layer bottoms
SHYFEM_H = 100.0


def shyfem_xy(lon, lat, L=20000.0):
    xm = 600000.0 + (np.asarray(lon) - SHYFEM_LON0) \
        / (SHYFEM_LON1 - SHYFEM_LON0) * L
    ym = 200000.0 + (np.asarray(lat) - SHYFEM_LAT0) \
        / (SHYFEM_LAT1 - SHYFEM_LAT0) * L
    return xm, ym


def make_shyfem(path):
    """Synthetic SHYFEM output with the REAL layout the reference
    reader handles (reference unstructured/shyfem.py:188-210): vars
    dimensioned (time, node, level), 'level' = positive-down layer
    bottoms, geographic node coordinates, standard_name attributes."""
    from scipy.io import netcdf_file
    rng = np.random.default_rng(23)
    side = 22
    glon, glat = np.meshgrid(
        np.linspace(SHYFEM_LON0, SHYFEM_LON1, side),
        np.linspace(SHYFEM_LAT0, SHYFEM_LAT1, side))
    jx = (SHYFEM_LON1 - SHYFEM_LON0) / side * 0.3
    jy = (SHYFEM_LAT1 - SHYFEM_LAT0) / side * 0.3
    lon = (glon + rng.uniform(-jx, jx, glon.shape)).ravel()
    lat = (glat + rng.uniform(-jy, jy, glat.shape)).ravel()
    n = len(lon)
    levels = SHYFEM_LEVELS
    nlev = len(levels)
    # layer-centre depths (what the data represents)
    zb = np.concatenate([[0.0], levels])
    centres = (zb[:-1] + zb[1:]) / 2.0
    times = [0.0, 3600.0, 7200.0]
    xm, ym = shyfem_xy(lon, lat)

    f = netcdf_file(path, "w")
    f.createDimension("time", len(times))
    f.createDimension("node", n)
    f.createDimension("level", nlev)
    for nm, data in [("longitude", lon), ("latitude", lat)]:
        v = f.createVariable(nm, "d", ("node",))
        v[:] = data
    lv = f.createVariable("level", "d", ("level",))
    lv[:] = levels
    t = f.createVariable("time", "d", ("time",))
    t[:] = times
    t.units = b"seconds since 2021-06-01T00:00:00"
    specs = [
        ("u_velocity", b"eastward_sea_water_velocity", "u"),
        ("v_velocity", b"northward_sea_water_velocity", "v"),
        ("temperature", b"sea_water_temperature", "T"),
        ("salinity", b"sea_water_salinity", "S"),
    ]
    cubes = {}
    for ti, tsec in enumerate(times):
        for li, d in enumerate(centres):
            frac = 1.0 - d / SHYFEM_H
            u, v, w, T, S = _fields(xm, ym, frac, tsec)
            for key, arr in (("u", u), ("v", v), ("T", T), ("S", S)):
                cubes.setdefault(key, np.zeros((len(times), n, nlev)))[
                    ti, :, li] = arr
    for nm, std, key in specs:
        v = f.createVariable(nm, "d", ("time", "node", "level"))
        v[:] = cubes[key]
        v.standard_name = std
    b = f.createVariable("total_depth", "d", ("node",))
    b[:] = SHYFEM_H
    b.standard_name = b"sea_floor_depth_below_sea_surface"
    f.close()
    return path


def shyfem_sample_points(n=600, seed=9):
    rng = np.random.default_rng(seed)
    lon = rng.uniform(SHYFEM_LON0 + 0.05 * (SHYFEM_LON1 - SHYFEM_LON0),
                      SHYFEM_LON1 - 0.05 * (SHYFEM_LON1 - SHYFEM_LON0), n)
    lat = rng.uniform(SHYFEM_LAT0 + 0.05 * (SHYFEM_LAT1 - SHYFEM_LAT0),
                      SHYFEM_LAT1 - 0.05 * (SHYFEM_LAT1 - SHYFEM_LAT0), n)
    z = -rng.uniform(0.5, 0.95 * SHYFEM_H, n)
    return lon, lat, z


def make_schism(path, nlev=5):
    """Synthetic SCHISM native output with the real layout the
    reference reader handles (reference reader_schism_native.py:55-310):
    projected node coordinates with standard_name
    projection_x/y_coordinate, time-varying zcor (time, node, lev)
    bottom-up, hvel (time, node, lev, 2), 3D temp/salt, elev/depth."""
    from scipy.io import netcdf_file
    x, y, tris = _mesh2d(seed=31)
    n = len(x)
    h = _depth(x, y)
    times = [0.0, 3600.0, 7200.0]

    f = netcdf_file(path, "w")
    f.createDimension("time", len(times))
    f.createDimension("node", n)
    f.createDimension("lev", nlev)
    f.createDimension("two", 2)
    f.createDimension("nele", len(tris))
    f.createDimension("three", 3)
    vx = f.createVariable("SCHISM_hgrid_node_x", "d", ("node",))
    vx[:] = x
    vx.standard_name = b"projection_x_coordinate"
    vy = f.createVariable("SCHISM_hgrid_node_y", "d", ("node",))
    vy[:] = y
    vy.standard_name = b"projection_y_coordinate"
    fc = f.createVariable("SCHISM_hgrid_face_nodes", "i",
                          ("nele", "three"))
    fc[:] = tris + 1
    dv = f.createVariable("depth", "d", ("node",))
    dv[:] = h
    t = f.createVariable("time", "d", ("time",))
    t[:] = times
    t.units = b"seconds since 2021-06-01 00:00:00"
    t.calendar = b"standard"
    # plane fractions bottom-up: level 0 at the seafloor
    fracs = np.linspace(0.0, 1.0, nlev)
    zcor = np.empty((len(times), n, nlev))
    hvel = np.empty((len(times), n, nlev, 2))
    temp = np.empty((len(times), n, nlev))
    salt = np.empty((len(times), n, nlev))
    elev = np.empty((len(times), n))
    for ti, ts in enumerate(times):
        elev[ti] = 0.0
        for li, fr in enumerate(fracs):
            zcor[ti, :, li] = -h * (1.0 - fr)
            u, v, w, T, S = _fields(x, y, fr, ts)
            hvel[ti, :, li, 0] = u
            hvel[ti, :, li, 1] = v
            temp[ti, :, li] = T
            salt[ti, :, li] = S
    for nm, data, dims in [("elev", elev, ("time", "node")),
                           ("zcor", zcor, ("time", "node", "lev")),
                           ("temp", temp, ("time", "node", "lev")),
                           ("salt", salt, ("time", "node", "lev"))]:
        v = f.createVariable(nm, "d", dims)
        v[:] = data
    v = f.createVariable("hvel", "d", ("time", "node", "lev", "two"))
    v[:] = hvel
    f.close()
    return path


def make_fvcom(path, nlay=5):
    """Synthetic FVCOM output with the layout the reference reader
    requires (reference reader_netCDF_CF_unstructured.py:85-200):
    Cartesian x/y/xc/yc + CoordinateSystem attr, MJD time with
    format/time_zone attrs, u/v on (time, siglay, nele) with
    eastward/northward standard names, siglay/siglev (+_center), h."""
    from scipy.io import netcdf_file
    x, y, tris = _mesh2d(seed=41)
    n = len(x)
    nele = len(tris)
    xc = x[tris].mean(axis=1)
    yc = y[tris].mean(axis=1)
    h = _depth(x, y)
    hc = _depth(xc, yc)
    # MJD days for 2021-06-01 00:00 + hourly frames
    mjd0 = (np.datetime64("2021-06-01") - np.datetime64("1858-11-17")
            ) / np.timedelta64(1, "D")
    times_s = [0.0, 3600.0, 7200.0]
    siglay = -(np.arange(nlay) + 0.5) / nlay       # layer centres
    siglev = -np.arange(nlay + 1) / nlay

    f = netcdf_file(path, "w")
    f.CoordinateProjection = TELEMAC_PROJ.encode()
    f.CoordinateSystem = b"Cartesian"
    f.createDimension("time", len(times_s))
    f.createDimension("node", n)
    f.createDimension("nele", nele)
    f.createDimension("siglay", nlay)
    f.createDimension("siglev", nlay + 1)
    f.createDimension("three", 3)
    for nm, data, dims in [("x", x, ("node",)), ("y", y, ("node",)),
                           ("xc", xc, ("nele",)),
                           ("yc", yc, ("nele",))]:
        v = f.createVariable(nm, "d", dims)
        v[:] = data
    nv = f.createVariable("nv", "i", ("three", "nele"))
    nv[:] = (tris + 1).T
    t = f.createVariable("time", "d", ("time",))
    t[:] = mjd0 + np.asarray(times_s) / 86400.0
    t.units = b"days since 1858-11-17 00:00:00"
    t.format = b"modified julian day (MJD)"
    t.time_zone = b"UTC"
    hv = f.createVariable("h", "d", ("node",))
    hv[:] = h
    hv.standard_name = b"sea_floor_depth_below_sea_level"
    hcv = f.createVariable("h_center", "d", ("nele",))
    hcv[:] = hc
    sl = f.createVariable("siglay", "d", ("siglay", "node"))
    sl[:] = np.broadcast_to(siglay[:, None], (nlay, n))
    sv = f.createVariable("siglev", "d", ("siglev", "node"))
    sv[:] = np.broadcast_to(siglev[:, None], (nlay + 1, n))
    slc = f.createVariable("siglay_center", "d", ("siglay", "nele"))
    slc[:] = np.broadcast_to(siglay[:, None], (nlay, nele))
    svc = f.createVariable("siglev_center", "d", ("siglev", "nele"))
    svc[:] = np.broadcast_to(siglev[:, None], (nlay + 1, nele))
    uu = np.empty((len(times_s), nlay, nele))
    vv = np.empty((len(times_s), nlay, nele))
    for ti, ts in enumerate(times_s):
        for li, sig in enumerate(siglay):
            frac = 1.0 + sig                      # 1 near surface
            u, v, w, T, S = _fields(xc, yc, frac, ts)
            uu[ti, li] = u
            vv[ti, li] = v
    vu = f.createVariable("u", "d", ("time", "siglay", "nele"))
    vu[:] = uu
    vu.standard_name = b"eastward_sea_water_velocity"
    vv_ = f.createVariable("v", "d", ("time", "siglay", "nele"))
    vv_[:] = vv
    vv_.standard_name = b"Northward_sea_water_velocity"
    f.close()
    return path


UTM33 = "+proj=utm +zone=33 +ellps=WGS84 +units=m +no_defs"
LOFOTEN_BOX = (12.0, 16.0, 67.0, 69.0)      # lon0, lon1, lat0, lat1


def lofoten_mesh(spacing_m=640.0, seed=0):
    """A jittered Delaunay mesh over LOFOTEN_BOX in UTM 33N with the land
    triangles of the bundled coastline raster removed and the nodes they
    alone used dropped.  Returns (x, y, triangles, land centroids (lon,
    lat)) in metres and node indices."""
    from scipy.spatial import Delaunay
    from ..fields.landmask import GlobalLandmask
    from ..utils import crs as crslib
    p = crslib.from_proj4(UTM33)
    lon0, lon1, lat0, lat1 = LOFOTEN_BOX
    blon, blat = np.meshgrid(np.linspace(lon0, lon1, 41),
                             np.linspace(lat0, lat1, 21))
    bx, by = p.fwd(np, blon.ravel(), blat.ravel())
    rng = np.random.default_rng(seed)
    gx, gy = np.meshgrid(np.arange(bx.min(), bx.max(), spacing_m),
                         np.arange(by.min(), by.max(), spacing_m))
    x = (gx + rng.uniform(-0.3, 0.3, gx.shape) * spacing_m).ravel()
    y = (gy + rng.uniform(-0.3, 0.3, gy.shape) * spacing_m).ravel()
    lon, lat = p.inv(np, x, y)
    keep = (lon >= lon0) & (lon <= lon1) & (lat >= lat0) & (lat <= lat1)
    x, y = x[keep], y[keep]
    tris = Delaunay(np.column_stack([x, y])).simplices
    clon, clat = p.inv(np, x[tris].mean(axis=1), y[tris].mean(axis=1))
    land = GlobalLandmask().contains(clon, clat)
    tris = tris[~land]
    used = np.zeros(len(x), dtype=bool)
    used[tris.ravel()] = True
    renumber = np.cumsum(used) - 1
    return (x[used], y[used], renumber[tris],
            np.column_stack([clon[land], clat[land]]))


def write_schism_lofoten(path, spacing_m=640.0, nlev=20, nt=9,
                         step_s=3600.0, seed=0):
    """SCHISM native output on :func:`lofoten_mesh` (about 60,000 nodes
    and 119,000 triangles at the default spacing; 220 MB): depth
    20-600 m rising away from the coast, a semidiurnal ``elev``, ``zcor``
    of ``nlev`` bottom-up levels following it, ``hvel`` of a mean eastward
    current of 0.3 m/s with eddies and shear, 3D ``temp`` and ``salt``;
    ``nt`` frames ``step_s`` apart.  Returns the path."""
    from scipy.io import netcdf_file
    from scipy.spatial import cKDTree
    from ..utils import crs as crslib
    x, y, tris, land = lofoten_mesh(spacing_m, seed)
    p = crslib.from_proj4(UTM33)
    lon, lat = p.inv(np, x, y)
    n = len(x)
    near_km = cKDTree(land * [np.cos(np.radians(68.0)), 1.0]).query(
        np.column_stack([lon * np.cos(np.radians(68.0)), lat]))[0] * 111.0
    h = 20.0 + 580.0 * (1.0 - np.exp(-near_km / 15.0))
    rng = np.random.default_rng(seed + 1)
    phase = rng.uniform(0, 2 * np.pi, 3)
    xs = (lon - 12.0) * 2 * np.pi / 1.3
    ys = (lat - 67.0) * 2 * np.pi / 0.6
    frac = np.linspace(0.0, 1.0, nlev)
    f = netcdf_file(path, "w", version=2)
    f.createDimension("time", nt)
    f.createDimension("node", n)
    f.createDimension("nSCHISM_hgrid_face", len(tris))
    f.createDimension("nMaxSCHISM_hgrid_face_nodes", 3)
    f.createDimension("lev", nlev)
    f.createDimension("two", 2)
    for name, data, std in (("SCHISM_hgrid_node_x", x,
                             b"projection_x_coordinate"),
                            ("SCHISM_hgrid_node_y", y,
                             b"projection_y_coordinate")):
        v = f.createVariable(name, "d", ("node",))
        v[:] = data
        v.standard_name = std
    fc = f.createVariable("SCHISM_hgrid_face_nodes", "i",
                          ("nSCHISM_hgrid_face",
                           "nMaxSCHISM_hgrid_face_nodes"))
    fc[:] = tris + 1
    dv = f.createVariable("depth", "f", ("node",))
    dv[:] = h
    tv = f.createVariable("time", "d", ("time",))
    tv[:] = np.arange(nt) * float(step_s)
    tv.units = b"seconds since 2024-03-01 00:00:00"
    tv.calendar = b"standard"
    ev = f.createVariable("elev", "f", ("time", "node"))
    zc = f.createVariable("zcor", "f", ("time", "node", "lev"))
    hv = f.createVariable("hvel", "f", ("time", "node", "lev", "two"))
    tp = f.createVariable("temp", "f", ("time", "node", "lev"))
    sa = f.createVariable("salt", "f", ("time", "node", "lev"))
    shear = (0.4 + 0.6 * frac)[None, :]
    for k in range(nt):
        ts = k * float(step_s)
        tide = 2 * np.pi * ts / 44712.0
        elev = 0.6 * np.sin(tide + 0.5 * xs)
        ev[k] = elev
        zc[k] = -h[:, None] + (h + elev)[:, None] * frac[None, :]
        u = 0.3 + 0.15 * np.sin(xs + phase[0]) * np.cos(ys) \
            + 0.1 * np.cos(tide)
        v = 0.12 * np.cos(xs) * np.sin(ys + phase[1]) \
            + 0.05 * np.sin(tide)
        hv[k, :, :, 0] = u[:, None] * shear
        hv[k, :, :, 1] = v[:, None] * shear
        tp[k] = 4.0 + 3.0 * frac[None, :] + 0.5 * np.sin(xs + phase[2]
                                                         )[:, None]
        sa[k] = 34.8 - 1.2 * frac[None, :] - 0.2 * np.cos(ys)[:, None]
    f.close()
    return path
