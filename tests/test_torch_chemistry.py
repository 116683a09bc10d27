"""The chemistry models of ``opendrift_tpu_torch`` (RadionuclideDrift and
ChemicalDrift with the speciation step and ``rng.split``) on the CPU,
against the JAX package on the same seeded inputs and against their
reference goldens.

Tolerances.  ``rng.split`` and the speciation uniforms are bit-equal.  The
speciation destinations may differ only where the two libraries' ``exp``
or ``cumsum`` round a probability to the other side of a uniform:
``SPECIATION_SHARE`` of the elements at most (0 measured at S = 5).  Runs
of 64 elements against the JAX package (on tests/test_torch_zoo.py's
``ArrayReader`` forcing) keep that file's bounds: statuses equal, lon, lat
and z within ``MEDIAN_ATOL``/``OUTLIER_ATOL`` under ``OUTLIER_SHARE``,
model variables within ``VAR_RTOL``, and ``specie`` equal but for
``SPECIATION_SHARE``.  The masses are held to ``MASS_TOL`` of the seeded
mass: degradation and volatilization move ``1 - exp(-k dt)`` of the mass a
step with ``k dt`` of 1e-5 to 1e-3, where one ulp of float32 ``exp`` near 1
(the two libraries' ``exp`` differ by one) is 6e-8 of the mass, 12 steps
in a run.  The goldens keep the bounds of
tests/test_reference_stat_parity.py.  The density maps and budgets of the
two packages' results share their bins to the bit and agree to
``MASS_TOL`` of the inventory.
"""

import os
from datetime import datetime, timedelta

import numpy as np
import pytest
import torch

from opendrift_tpu_torch import rng
from opendrift_tpu_torch.tools import parity_compare as parity
from opendrift_tpu_torch.tools import zoo_setups
from test_torch_oceandrift import MEDIAN_ATOL, OUTLIER_ATOL
from test_torch_zoo import N, T0, VAR_ATOL, VAR_RTOL, _assert_close, \
    _forcing

SPECIATION_SHARE = 0.01
MASS_TOL = 1e-6


def _jkey(key):
    return tuple(int(x) for x in np.asarray(key))


# ------------------------------------------------------ split, speciation --

@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 + 5, -3])
def test_split_bit_equal_jax(seed):
    """``rng.split`` against ``jax.random.split`` on many keys: the root
    key and keys folded as the engine folds them (interval, step, use)."""
    import jax
    jk, tk = jax.random.PRNGKey(seed), rng.PRNGKey(seed)
    for a in range(5):
        for b in range(0, 40, 3):
            jsub = jax.random.fold_in(jax.random.fold_in(jk, a), b)
            tsub = rng.fold_in(rng.fold_in(tk, a), b)
            for num in (2, 3):
                want = [_jkey(k) for k in jax.random.split(jsub, num)]
                assert [tuple(k) for k in rng.split(tsub, num)] == want


def _speciation_inputs(n=20_000, S=5, seed=0):
    r = np.random.default_rng(seed)
    specie = r.integers(0, S, n).astype(np.int32)
    # rates of 1e-7 to 1e-3 1/s, a few zero, as the rate matrices give
    rates = (10.0 ** r.uniform(-7, -3, (n, S))).astype(np.float32)
    rates[r.random((n, S)) < 0.3] = 0.0
    active = r.random(n) < 0.95
    return specie, rates, active


@pytest.mark.parametrize("dt", [1800.0, -900.0, 60.0])
def test_speciation_step_matches_jax(dt):
    """``ops/speciation.py`` on seeded (N, 5) rates: its two uniforms are
    bit-equal to the JAX package's, and the destinations equal but for
    ``SPECIATION_SHARE``."""
    import jax
    import jax.numpy as jnp
    from opendrift_tpu.ops.speciation import speciation_step as jstep
    from opendrift_tpu_torch.ops.speciation import speciation_step
    specie, rates, active = _speciation_inputs()
    jk = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    tk = rng.fold_in(rng.PRNGKey(7), 3)
    for jsub, tsub in zip(jax.random.split(jk), rng.split(tk)):
        np.testing.assert_array_equal(
            rng.uniform(tsub, specie.shape).numpy(),
            np.asarray(jax.random.uniform(jsub, specie.shape)))
    want_sp, want_tr = jstep(jnp.asarray(specie), jnp.asarray(rates),
                             jnp.float32(dt), jk, jnp.asarray(active))
    got_sp, got_tr = speciation_step(torch.as_tensor(specie),
                                     torch.as_tensor(rates), dt, tk,
                                     torch.as_tensor(active))
    assert got_sp.dtype == torch.int32
    assert np.mean(got_tr.numpy() != np.asarray(want_tr)) <= SPECIATION_SHARE
    assert np.mean(got_sp.numpy() != np.asarray(want_sp)) <= SPECIATION_SHARE
    assert 0.0 < got_tr.numpy().mean() < 0.95
    assert not (got_tr.numpy() & ~active).any()


def test_speciation_destination_is_the_first_reached():
    """A row whose cumulative sum never reaches the uniform (a sum that
    rounds below 1) falls back to index 0, as ``jnp.argmax`` of an
    all-False row does; otherwise the first reached destination wins."""
    from opendrift_tpu_torch.ops.speciation import speciation_step
    rates = torch.tensor([[0.0, 1.0, 1.0, 0.0, 0.0],
                          [0.0, 0.0, 0.0, 0.0, 0.0]], dtype=torch.float32)
    specie = torch.tensor([3, 4], dtype=torch.int32)
    new, tr = speciation_step(specie, rates, 1e6, rng.PRNGKey(0),
                              torch.tensor([True, True]))
    assert tr.tolist() == [True, False]
    assert new[0].item() in (1, 2) and new[1].item() == 4
    reached = torch.zeros((3, 5), dtype=torch.uint8)
    assert torch.argmax(reached, dim=1).tolist() == [0, 0, 0]


# ------------------------------------------------------------- the models --

# case -> (class name, config, seed kwargs, model variables to compare)
CASES = {
    "radionuclide_137Cs": ("RadionuclideDrift", {
        "radionuclide:transformations:Dc": 2e-4}, {}, ("diameter",)),
    "radionuclide_slow_irrev": ("RadionuclideDrift", {
        "radionuclide:specie_setup": "LMM + Rev + Slow rev + Irrev",
        "radionuclide:transformations:Dc": 2e-4,
        "radionuclide:transformations:slow_coeff": 1e-4}, {}, ("diameter",)),
    "radionuclide_Al_colloid": ("RadionuclideDrift", {
        "radionuclide:isotope": "Al",
        "radionuclide:specie_setup": "LMM + Colloid + Rev",
        "radionuclide:transformations:Dc": 2e-4}, {"specie": 0},
        ("diameter",)),
    "chemical_nondiss": ("ChemicalDrift", {
        "chemical:compound": "Phenanthrene",
        "chemical:transformations:volatilization": True},
        {}, ("mass", "mass_degraded", "mass_volatilized", "diameter")),
    "chemical_acid": ("ChemicalDrift", {
        "chemical:transformations:dissociation": "acid",
        "chemical:transformations:pKa_acid": 4.2,
        "chemical:transformations:KOC_sed": 50.0,
        "chemical:transformations:volatilization": True},
        {}, ("mass", "mass_degraded", "mass_volatilized", "diameter")),
    "chemical_metals": ("ChemicalDrift", {
        "chemical:compound": "Copper",
        "chemical:transformations:slow_coeff": 1e-5,
        "chemical:transformations:Dc": 2e-4}, {}, ("mass", "diameter")),
    # seeded at the seafloor, under currents too slow to resuspend:
    # sorption to the sediment and freezing there run
    "radionuclide_seabed": ("RadionuclideDrift", {
        "seed:seafloor": True,
        "radionuclide:sediment:resuspension_critvel": 10.0},
        {}, ("diameter", "moving")),
    "chemical_seabed": ("ChemicalDrift", {
        "seed:seafloor": True, "chemical:transformations:KOC_sed": 50.0,
        "chemical:sediment:resuspension_critvel": 1.0},
        {}, ("mass", "mass_degraded", "moving")),
}


def _chem_run(pkg, case, **extra_config):
    cls_name, config, seed_kw, _ = CASES[case]
    config = {**config, **extra_config}
    if pkg == "jax":
        import opendrift_tpu.models as M
        from opendrift_tpu.fields import ArrayReader
        o = getattr(M, cls_name)(loglevel=40)
    else:
        import opendrift_tpu_torch.models as M
        from opendrift_tpu_torch.fields import ArrayReader
        o = getattr(M, cls_name)(loglevel=40, device="cpu")
    ocean, wind, _, x, y, depths, times = _forcing()
    o.add_reader(ArrayReader(ocean, x, y, times, depths=depths))
    o.add_reader(ArrayReader(wind, x, y, times))
    o.set_config("environment:fallback:land_binary_mask", 0)
    spm = "spm" if cls_name == "ChemicalDrift" else "conc3"
    o.set_config(f"environment:fallback:{spm}",
                 20.0 if spm == "spm" else 5e-3)
    for key, value in config.items():
        o.set_config(key, value)
    if config.get("chemical:compound"):
        o.init_chemical_compound()
    r = np.random.default_rng(1)
    # seeded near the seafloor too, so that sorption to the sediment runs
    np.random.seed(5)
    o.seed_elements(lon=r.uniform(3.5, 4.5, N), lat=r.uniform(59.4, 60.1, N),
                    z=-r.uniform(0.0, 30.0, N), number=N, time=times[0],
                    **seed_kw)
    o.run(duration=timedelta(hours=3), time_step=900, time_step_output=3600)
    return o


@pytest.mark.parametrize("case", list(CASES))
def test_model_run_matches_jax(case):
    """Each chemistry configuration from one seed in both packages: the
    same statuses, positions, species and model variables; species change
    in the run."""
    oj = _chem_run("jax", case)
    ot = _chem_run("torch", case)
    assert ot.result["lon"].shape == oj.result["lon"].shape == (N, 4)
    np.testing.assert_array_equal(ot.result["status"].values,
                                  np.asarray(oj.result["status"].values))
    for var in ("lon", "lat", "z"):
        _assert_close(ot.result[var].values, oj.result[var].values, var,
                      MEDIAN_ATOL[var], OUTLIER_ATOL[var])
    sp_t = np.asarray(ot.result["specie"].values)
    sp_j = np.asarray(oj.result["specie"].values)
    assert np.mean(sp_t != sp_j) <= SPECIATION_SHARE
    assert (sp_t[:, -1] != sp_t[:, 0]).any(), "no element changed specie"
    if case.endswith("seabed"):
        sed = np.zeros(sp_t.shape, bool)
        for i, name in enumerate(ot.name_species):
            if name.startswith("Sediment"):
                sed |= sp_t == i
        assert sed[:, 1:].any(), "no element sorbed to the sediment"
        assert (ot.result["moving"].values[sed] == 0).all()
    for var in CASES[case][3]:
        want = np.asarray(oj.result[var].values, np.float64)
        scale = np.abs(want[~np.isnan(want)])
        atol = VAR_ATOL + VAR_RTOL * (np.median(scale) if scale.size else 0)
        if var.startswith("mass"):
            atol = MASS_TOL * np.median(oj.result["mass"].values[:, 0])
        _assert_close(ot.result[var].values, want, var, atol, 10 * atol)


def test_transfer_rates_equal_jax():
    """The host-built rate matrices of every speciation setup equal the
    JAX package's (both float64 on the host, cast to float32)."""
    import opendrift_tpu.models as J
    import opendrift_tpu_torch.models as T
    setups = [("RadionuclideDrift", {"radionuclide:specie_setup": s})
              for s in ("LMM + Rev", "LMM + Rev + Slow rev",
                        "LMM + Rev + Irrev", "LMM + Rev + Slow rev + Irrev")]
    setups += [("RadionuclideDrift", {"radionuclide:isotope": "Al",
                "radionuclide:specie_setup": "LMM + Colloid + Rev"}),
               ("RadionuclideDrift", {"radionuclide:isotope": "manual",
                "radionuclide:transformations:Kd": 30.0}),
               ("ChemicalDrift", {}),
               ("ChemicalDrift", {"chemical:transfer_setup": "metals",
                "chemical:transformations:slow_coeff": 1e-6})]
    for name, config in setups:
        pair = [getattr(J, name)(loglevel=40),
                getattr(T, name)(loglevel=40, device="cpu")]
        for o in pair:
            for k, v in config.items():
                o.set_config(k, v)
        want, got = (o.transfer_rates_matrix() for o in pair)
        assert got.dtype == np.float32 and got.any()
        np.testing.assert_array_equal(got, want, err_msg=str(config))
    with pytest.raises(ValueError, match="Illegal speciation"):
        o = T.RadionuclideDrift(loglevel=40, device="cpu")
        o.set_config("radionuclide:isotope", "129I")
        o.set_config("radionuclide:specie_setup", "LMM + Rev + Irrev")
        o.transfer_rates_matrix()


def test_corrections_equal_jax():
    """``tempcorr`` and ``salinitycorr`` on Python floats and on tensors,
    and the pH KOC corrections of every dissociation state."""
    from opendrift_tpu.models import ChemicalDrift as J
    from opendrift_tpu_torch.models import ChemicalDrift as T
    r = np.random.default_rng(2)
    Tw = r.uniform(-1.0, 25.0, 1000).astype(np.float32)
    Sw = r.uniform(0.0, 38.0, 1000).astype(np.float32)
    pH = r.uniform(6.5, 8.5, 1000).astype(np.float32)
    for DH in (-25900.0, 50000.0):
        want = float(J.tempcorr(DH, 12.0, 25.0))
        assert T.tempcorr(DH, 12.0, 25.0) == pytest.approx(want, rel=1e-6)
        np.testing.assert_allclose(
            T.tempcorr(DH, torch.as_tensor(Tw), 25.0).numpy(),
            np.asarray(J.tempcorr(DH, Tw, 25.0)), rtol=2e-6)
    assert T.salinitycorr(0.3, 12.0, 34.0) == pytest.approx(
        float(J.salinitycorr(0.3, 12.0, 34.0)), rel=1e-6)
    np.testing.assert_allclose(
        T.salinitycorr(0.3, torch.as_tensor(Tw), torch.as_tensor(Sw)).numpy(),
        np.asarray(J.salinitycorr(0.3, Tw, Sw)), rtol=2e-6)
    KOW = 10.0 ** 3.4
    for diss in ("nondiss", "acid", "base", "amphoter"):
        args = (900.0, 800.0, 4.2, 9.1, KOW)
        np.testing.assert_allclose(
            T.calc_KOC_corr_particle(*args, torch.as_tensor(pH),
                                     diss).numpy(),
            np.asarray(J.calc_KOC_corr_particle(*args, pH, diss)),
            rtol=2e-6, err_msg=diss)
        np.testing.assert_allclose(
            T.calc_KOC_corr_DOM(*args, torch.as_tensor(pH), diss).numpy(),
            np.asarray(J.calc_KOC_corr_DOM(*args, pH, diss)), rtol=2e-6,
            err_msg=diss)


# -------------------------------------------------------------- goldens --

CHEM_GOLDENS = ["chemical_stat", "radionuclide_stat"]


def test_zoo_configs_carry_the_chemistry_goldens_scalars():
    for name in CHEM_GOLDENS:
        _, cfg = parity.load_golden(name)
        want = {k: v for k, v in cfg.items()
                if not isinstance(v, list) and k != "n"}
        assert zoo_setups.CONFIGS[name] == want, name


@pytest.mark.parametrize("name", CHEM_GOLDENS)
def test_matches_reference_golden(name):
    """The reference OpenDrift's ChemicalDrift (Phenanthrene) and 137Cs
    RadionuclideDrift runs under constant fallbacks, through the port's
    parity tool at the bounds of tests/test_reference_stat_parity.py."""
    rec = parity.check(name, "cpu")
    assert rec["status"] == "pass", rec


# ---------------------------------------------------- diagnostics, seeding --

@pytest.fixture(scope="module")
def chem_pair():
    return _chem_run("jax", "chemical_nondiss"), \
        _chem_run("torch", "chemical_nondiss")


def test_density_maps_and_budget_match_jax(chem_pair, tmp_path):
    """``get_chemical_density_array``, ``get_pixel_mean_depth``, the
    density-map file (smoothed and time-averaged), the budget and the
    summary of the port's result against the JAX package's."""
    from scipy.io import netcdf_file
    oj, ot = chem_pair
    zlevels = [-20.0, -10.0, -2.0]
    Hj, lonj, latj, bj = oj.get_chemical_density_array(2000.0, zlevels)
    Ht, lont, latt, bt = ot.get_chemical_density_array(2000.0, zlevels)
    for a, b in ((lont, lonj), (latt, latj), (bt, bj)):
        np.testing.assert_array_equal(a, b)
    inventory = np.nansum(ot.result["mass"].values[:, 0])
    np.testing.assert_allclose(Ht, Hj, rtol=0, atol=MASS_TOL * inventory)
    assert Ht.shape[1:3] == (5, 3) and Ht.sum() > 0
    lon_c = 0.5 * (lont[:-1] + lont[1:])[::4]
    lat_c = np.full(lon_c.shape, 0.5 * (latt[0] + latt[-1]))
    np.testing.assert_allclose(ot.get_pixel_mean_depth(lon_c, lat_c),
                               oj.get_pixel_mean_depth(lon_c, lat_c),
                               rtol=1e-6)
    files = []
    for o, tag in ((oj, "jax"), (ot, "port")):
        path = str(tmp_path / f"conc_{tag}.nc")
        o.write_netcdf_chemical_density_map(
            path, pixelsize_m=2000.0, zlevels=zlevels, mass_unit="mg",
            horizontal_smoothing=True, time_avg_conc=True)
        files.append(netcdf_file(path, "r", mmap=False))
    for var in ("time", "depth", "lon", "lat", "concentration",
                "concentration_avg"):
        want = files[0].variables[var][:]
        np.testing.assert_allclose(
            files[1].variables[var][:], want, rtol=0,
            atol=MASS_TOL * np.nanmax(np.abs(want)), err_msg=var)
    assert files[1].variables["concentration"].units == b"mg/L"
    for f in files:
        f.close()
    bj, bt = oj.get_chemical_budget(), ot.get_chemical_budget()
    inventory = bt["mass_total_active"][0]
    for k in bj:
        np.testing.assert_allclose(bt[k], bj[k], rtol=0,
                                   atol=MASS_TOL * inventory)
    total = bt["mass_total_active"] + bt["mass_degraded"] \
        + bt["mass_volatilized"]
    np.testing.assert_allclose(total, total[0], rtol=1e-5)
    assert bt["mass_degraded"][-1] > 0 and bt["mass_volatilized"][-1] > 0


def test_summary_and_plot_stub(chem_pair, capsys):
    oj, ot = chem_pair
    oj.simulation_summary()
    want = capsys.readouterr().out
    ot.simulation_summary()
    assert capsys.readouterr().out == want
    assert "Final speciation" in want
    # the plot is ported: it draws the three bands of the budget
    import matplotlib
    matplotlib.use("Agg")
    fig = ot.plot_mass()
    assert [t.get_text() for t in fig.axes[0].get_legend().get_texts()] \
        == ["active", "degraded", "volatilized"]
    assert len(fig.axes[0].collections) == 3


def test_radionuclide_density_map_and_gui_postproc(tmp_path):
    """The radionuclide density map and the GUI's post-processing against
    the JAX package's on the same configuration; the two GUI plots draw
    from it (their artists: tests/test_torch_plots.py)."""
    from scipy.io import netcdf_file
    oj = _chem_run("jax", "radionuclide_137Cs")
    ot = _chem_run("torch", "radionuclide_137Cs")
    files = []
    for o, tag in ((oj, "jax"), (ot, "port")):
        path = str(tmp_path / f"radio_{tag}.nc")
        assert o.gui_postproc(filename=path, pixelsize_m=3000.0) == path
        files.append(netcdf_file(path, "r", mmap=False))
    for var in ("time", "depth", "lon", "lat", "density"):
        np.testing.assert_array_equal(files[1].variables[var][:],
                                      files[0].variables[var][:],
                                      err_msg=var)
    assert files[1].variables["density"][:].sum() > 0
    for f in files:
        f.close()
    import matplotlib
    matplotlib.use("Agg")
    pngs = [o.guipp_plotandsaveconc(str(tmp_path / f"radio_{tag}.nc"),
                                    str(tmp_path / tag), zlayers=[0])
            for o, tag in ((oj, "jax"), (ot, "port"))]
    assert len(pngs[1]) == len(pngs[0]) > 0
    assert all(os.path.exists(p) for p in pngs[1])
    anim = ot.guipp_showanimationprofile()
    assert anim._save_count == ot.result.dims["time"]


def test_seed_from_dataarray_with_datetime64_matches_jax():
    """Seeding from a gridded discharge field with ``datetime64`` times
    (an xarray-like object) gives the JAX package's seeds; the times
    become ``datetime``s without pandas."""
    from opendrift_tpu.models import ChemicalDrift as J
    from opendrift_tpu_torch.models import ChemicalDrift as T

    class Field:
        pass
    f = Field()
    r = np.random.default_rng(4)
    f.data = r.uniform(0.0, 3.0, (3, 4, 5))
    f.data[f.data < 1.0] = 0.0
    f.longitude = np.linspace(3.0, 4.0, 5)
    f.latitude = np.linspace(59.0, 60.0, 4)
    f.time = np.array(["2021-04-01T00:00", "2021-04-01T06:00",
                       "2021-04-01T12:00:00.000123456"],
                      dtype="datetime64[ns]")
    seeds = []
    for o in (J(loglevel=40), T(loglevel=40, device="cpu")):
        np.random.seed(11)
        o.seed_from_DataArray(f, scrubber_type="open_loop",
                              chemical_compound="Copper",
                              mass_element_ug=2e4, number_of_elements=None)
        seeds.append(o._seedings)
    assert len(seeds[0]) == len(seeds[1]) > 5
    for sj, st in zip(*seeds):
        assert set(sj) == set(st)
        for k in sj:
            np.testing.assert_equal(st[k], sj[k], err_msg=k)
    times = {t for s in seeds[1] for t in np.atleast_1d(s["time"])}
    assert all(type(t) is datetime for t in times)
    assert datetime(2021, 4, 1, 12, 0, 0, 123) in times
    assert T.emission_factors(T, "AFP_metals_total", "Copper") == 1e6


def test_compound_presets_and_species_names():
    from opendrift_tpu_torch.models import ChemicalDrift, RadionuclideDrift
    o = ChemicalDrift(loglevel=40, device="cpu")
    assert o.specie_num2name(2) == "Particle reversible"
    o.init_chemical_compound("Copper")
    assert o.get_config("chemical:transfer_setup") == "metals"
    assert o.nspecies == 5 and o.name_species[2] == \
        "Particle slowly reversible"
    with pytest.raises(ValueError):
        o.init_chemical_compound("Unobtainium")
    r = RadionuclideDrift(loglevel=40, device="cpu")
    r.set_config("radionuclide:specie_setup", "LMM + Rev + Slow rev")
    assert r.nspecies == 5
    r.seed_elements(lon=4.0, lat=60.0, number=100, time=T0)
    sp = r._seedings[0]["specie"]
    assert (sp == 0).sum() == 10 and (sp == 1).sum() == 90
    dia = r._seedings[0]["diameter"]
    assert (dia[sp == 0] == 0).all() and (dia[sp == 1] > 0).all()
