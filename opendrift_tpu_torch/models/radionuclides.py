"""RadionuclideDrift: multi-species radionuclide transport and fate.

Port of ``opendrift_tpu/models/radionuclides.py`` (reference:
opendrift/models/radionuclides.py:27-1774): a per-element integer specie
(LMM dissolved, particle reversible, sediment reversible, optionally the
slowly reversible and irreversible pools, or the Al colloid chemistry), a
Kd/Dc-derived transfer-rate matrix (Simonsen et al. 2019) built on the
host, stochastic speciation through ``ops/speciation.py``, sorption to and
desorption from the sediment with the moving flag frozen, Stokes sinking
of the particle species and resuspension.  Its ``bottom_interaction`` and
``terminal_velocity_inner`` override substep hooks, so the Visser walk
takes OceanDrift's generic per-substep loop and no mixing kernel.
"""

import logging

import numpy as np
import torch

from .. import rng
from ..config import CONFIG_LEVEL_ADVANCED, CONFIG_LEVEL_ESSENTIAL
from ..ops.speciation import speciation_step
from ..ops import physics as ph
from ..utils.plotting import pyplot, use_agg
from .oceandrift import OceanDrift, Lagrangian3DArray

logger = logging.getLogger(__name__)

G = 9.81


class Radionuclide(Lagrangian3DArray):
    """(reference radionuclides.py:27-56)."""

    variables = Lagrangian3DArray.add_variables([
        ("diameter", {"dtype": np.float32, "units": "m", "default": 0.0}),
        ("neutral_buoyancy_salinity", {"dtype": np.float32, "units": "1",
                                       "default": 31.25}),
        ("density", {"dtype": np.float32, "units": "kg/m^3",
                     "default": 2650.0,
                     "description": "Mineral-particle density"}),
        ("specie", {"dtype": np.int32, "units": "1", "default": 0}),
        ("LMM_fraction", {"dtype": np.float32, "units": "1",
                          "default": 0.1}),
        ("particle_fraction", {"dtype": np.float32, "units": "1",
                               "default": 0.9}),
    ])


# IAEA (2004) Kd values per isotope (reference radionuclides.py:487-492)
KD_VALUES = {"137Cs": 4.0, "129I": 7.0e-2, "241Am": 2.0e3}


def on_device(sim, device, *arrays):
    """Host arrays (the transfer rates) on ``device``, copied there once
    per set of values and kept on ``sim``, not once a step: a copy from
    the host waits for the card."""
    key = (str(device),) + tuple((a.shape, a.tobytes()) for a in arrays)
    cached = getattr(sim, "_device_arrays", None)
    if cached is None or cached[0] != key:
        sim._device_arrays = (key, tuple(torch.as_tensor(a, device=device)
                                         for a in arrays))
    return sim._device_arrays[1]


def resuspend(ctx, srev, prev, critvel, lift, std):
    """Lift sedimented elements (specie ``srev`` on the seafloor) where the
    current speed reaches ``critvel``: ``lift`` m above the seabed, plus a
    Gaussian of ``std`` m (its key taken only when ``std`` > 0), moving
    again as specie ``prev``.  RadionuclideDrift's and ChemicalDrift's
    resuspension (reference radionuclides.py and chemicaldrift.py:
    1633-1680)."""
    d = ctx.state.data
    zmin = -ctx.environment["sea_floor_depth_below_sea_level"]
    speed = torch.hypot(ctx.environment["x_sea_water_velocity"],
                        ctx.environment["y_sea_water_velocity"])
    resusp = ctx.active & (d["specie"] == srev) & (d["z"] <= zmin) \
        & (speed >= critvel)
    if std > 0:
        dz = torch.clamp_min(lift + std * rng.normal(
            ctx.next_key(), tuple(d["z"].shape), d["z"].device), 0.0)
    else:
        dz = max(lift, 0.0)
    new_z = torch.clamp_max(zmin + dz, 0.0)
    ctx.set_var("z", torch.where(resusp, new_z, d["z"]))
    ctx.set_var("moving", torch.where(resusp, 1.0, d["moving"]))
    ctx.set_var("specie", torch.where(resusp, prev, d["specie"]))


class RadionuclideDrift(OceanDrift):
    """Radionuclide transport model (reference radionuclides.py:58)."""

    ElementType = Radionuclide

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "sea_surface_height": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "land_binary_mask": {"fallback": None},
        "sea_floor_depth_below_sea_level": {"fallback": 100},
        "ocean_vertical_diffusivity": {"fallback": 0.0001,
                                       "profiles": True},
        "sea_water_temperature": {"fallback": 10},
        "sea_water_salinity": {"fallback": 34},
        "upward_sea_water_velocity": {"fallback": 0},
        "conc3": {"fallback": 1.0e-3},
        "ocean_mixed_layer_thickness": {"fallback": 50},
    }

    def add_config(self):
        super().add_config()
        self._add_config({
            "radionuclide:isotope": {
                "type": "enum", "enum": list(KD_VALUES) + ["Al", "manual"],
                "default": "137Cs", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Radionuclide isotope (sets Kd)"},
            "radionuclide:specie_setup": {
                "type": "enum",
                "enum": ["LMM + Rev", "LMM + Rev + Slow rev",
                         "LMM + Rev + Irrev",
                         "LMM + Rev + Slow rev + Irrev",
                         "LMM + Colloid + Rev"],
                "default": "LMM + Rev", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Speciation scheme"},
            "radionuclide:transformations:Kd": {
                "type": "float", "default": 2.0, "min": 0, "max": 1e9,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Manual Kd (m3/kg)"},
            "radionuclide:transformations:Dc": {
                "type": "float", "default": 1.16e-5, "min": 0, "max": 1,
                "units": "1/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Desorption rate coefficient"},
            "radionuclide:transformations:slow_coeff": {
                "type": "float", "default": 1.2e-7, "min": 0, "max": 1,
                "units": "1/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Slow reversibility coefficient"},
            "radionuclide:particle_diameter": {
                "type": "float", "default": 5e-6, "min": 0, "max": 1e-3,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Diameter of particle-bound species"},
            "radionuclide:particle_diameter_uncertainty": {
                "type": "float", "default": 1e-7, "min": 0, "max": 1e-4,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Diameter spread at speciation"},
            "radionuclide:sediment:sedmixdepth": {
                "type": "float", "default": 1.0, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment mixing depth"},
            "radionuclide:sediment:sediment_density": {
                "type": "float", "default": 2600.0, "min": 0, "max": 10000,
                "units": "kg/m3", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment particle density"},
            "radionuclide:sediment:effective_fraction": {
                "type": "float", "default": 0.9, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Fraction of effective sorbents"},
            "radionuclide:sediment:corr_factor": {
                "type": "float", "default": 0.1, "min": 0, "max": 10,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment correction factor"},
            "radionuclide:sediment:porosity": {
                "type": "float", "default": 0.6, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment porosity"},
            "radionuclide:sediment:layer_thick": {
                "type": "float", "default": 1.0, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Seabed interaction layer thickness"},
            "radionuclide:sediment:desorption_depth": {
                "type": "float", "default": 1.0, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Height above seabed after desorption"},
            "radionuclide:sediment:desorption_depth_uncert": {
                "type": "float", "default": 0.5, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Desorption depth spread"},
            "radionuclide:sediment:resuspension_critvel": {
                "type": "float", "default": 0.01, "min": 0, "max": 10,
                "units": "m/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Critical near-bottom speed for "
                "resuspension (reference radionuclides.py:196)"},
            "radionuclide:sediment:resuspension_depth": {
                "type": "float", "default": 1.0, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Height above seabed of resuspended "
                "elements"},
            "radionuclide:sediment:resuspension_depth_uncert": {
                "type": "float", "default": 0.5, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Gaussian spread of resuspension height"},
            "seed:LMM_fraction": {
                "type": "float", "default": 0.1, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Fraction seeded as dissolved LMM"},
            "seed:particle_fraction": {
                "type": "float", "default": 0.9, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Fraction seeded as particle-bound"},
            "seed:total_release": {
                "type": "float", "default": 100e9, "min": 0, "max": 1e36,
                "units": "Bq", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Total released activity"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("drift:vertical_mixing", True)
        self.register_status("sedimented")

    # ------------------------------------------------------ species setup -
    @property
    def name_species(self):
        """(reference radionuclides.py:240-270)."""
        setup = self.get_config("radionuclide:specie_setup")
        if setup == "LMM + Colloid + Rev":
            return ["LMMcation", "LMManion", "Humic colloid", "Polymer",
                    "Particle reversible", "Sediment reversible"]
        names = ["LMM", "Particle reversible", "Sediment reversible"]
        if "Slow rev" in setup:
            names += ["Particle slowly reversible",
                      "Sediment slowly reversible"]
        if "Irrev" in setup:
            names += ["Particle irreversible", "Sediment irreversible"]
        return names

    def check_speciation(self):
        """Isotope/speciation compatibility (reference
        radionuclides.py:320-341; raises instead of exit())."""
        isotope = self.get_config("radionuclide:isotope")
        setup = self.get_config("radionuclide:specie_setup")
        legal = {
            "137Cs": ["LMM + Rev", "LMM + Rev + Slow rev",
                      "LMM + Rev + Irrev", "LMM + Rev + Slow rev + Irrev"],
            "129I": ["LMM + Rev", "LMM + Rev + Slow rev + Irrev"],
            "241Am": ["LMM + Rev", "LMM + Rev + Slow rev",
                      "LMM + Rev + Slow rev + Irrev"],
            "Al": ["LMM + Colloid + Rev"],
        }
        if isotope != "manual" and setup not in legal[isotope]:
            raise ValueError(
                f"Illegal speciation for {isotope}: {setup} "
                f"(legal: {legal[isotope]})")

    @property
    def nspecies(self):
        return len(self.name_species)

    def specie_name2num(self, name):
        return self.name_species.index(name)

    def _kd(self):
        isotope = self.get_config("radionuclide:isotope")
        if isotope == "manual":
            return self.get_config("radionuclide:transformations:Kd")
        return KD_VALUES[isotope]

    def transfer_rates_matrix(self):
        """Background transfer-rate matrix (S, S), or (4, S, S) keyed by
        salinity interval for the Al colloid chemistry
        (reference radionuclides.py:512-650)."""
        self.check_speciation()
        if self.get_config("radionuclide:specie_setup") \
                == "LMM + Colloid + Rev":
            return self._colloid_transfer_rates()
        S = self.nspecies
        rates = np.zeros((S, S), dtype=np.float32)
        lmm = self.specie_name2num("LMM")
        prev = self.specie_name2num("Particle reversible")
        srev = self.specie_name2num("Sediment reversible")
        Kd = self._kd()
        Dc = self.get_config("radionuclide:transformations:Dc")
        susp_mat = 1.0e-3
        sedmix = self.get_config("radionuclide:sediment:sedmixdepth")
        dens = self.get_config("radionuclide:sediment:sediment_density")
        f = self.get_config("radionuclide:sediment:effective_fraction")
        phi = self.get_config("radionuclide:sediment:corr_factor")
        poro = self.get_config("radionuclide:sediment:porosity")
        thick = self.get_config("radionuclide:sediment:layer_thick")
        rates[lmm, prev] = Dc * Kd * susp_mat
        rates[prev, lmm] = Dc
        rates[lmm, srev] = Dc * Kd * sedmix * dens * (1 - poro) * f * phi \
            / thick
        rates[srev, lmm] = Dc * phi
        setup = self.get_config("radionuclide:specie_setup")
        if "Slow rev" in setup:
            psrev = self.specie_name2num("Particle slowly reversible")
            ssrev = self.specie_name2num("Sediment slowly reversible")
            slow = self.get_config("radionuclide:transformations:slow_coeff")
            rates[srev, ssrev] = slow
            rates[prev, psrev] = slow
            rates[ssrev, srev] = slow * 0.1
            rates[psrev, prev] = slow * 0.1
        if "Irrev" in setup and "Slow rev" in setup:
            # the irreversible pools fill from the slow pools; without
            # them the irrev species are seed-only (as in the reference,
            # whose '+ irrev' rates also read the slow-pool indices)
            pirr = self.specie_name2num("Particle irreversible")
            sirr = self.specie_name2num("Sediment irreversible")
            slow = self.get_config("radionuclide:transformations:slow_coeff")
            rates[ssrev, sirr] = slow
            rates[psrev, pirr] = slow
        return rates

    def _colloid_transfer_rates(self):
        """Salinity-banded Al speciation rates, Simonsen et al. (2019b)
        (reference radionuclides.py:585-650).  Returns (4, S, S); band
        edges ``salinity_intervals`` = [0, 1, 10, 20] psu."""
        S = self.nspecies
        Dc = self.get_config("radionuclide:transformations:Dc")
        cat = self.specie_name2num("LMMcation")
        an = self.specie_name2num("LMManion")
        hum = self.specie_name2num("Humic colloid")
        pol = self.specie_name2num("Polymer")
        prev = self.specie_name2num("Particle reversible")
        srev = self.specie_name2num("Sediment reversible")
        self.salinity_intervals = (0.0, 1.0, 10.0, 20.0)
        r = np.zeros((4, S, S), dtype=np.float32)
        # (band, source, dest): adsorption to humics/particles/polymer
        # strengthens and desorption quickens with salinity
        r[0, cat, hum] = 1.2e-5
        r[0, cat, prev] = 4.0e-6
        r[0, hum, cat] = 0.3 * Dc
        r[0, hum, prev] = 2.0e-6
        r[0, prev, cat] = 0.3 * Dc
        r[0, srev, cat] = 0.03 * Dc
        r[1, cat, hum] = 1.0e-5
        r[1, cat, prev] = 3.0e-6
        r[1, cat, pol] = 1.2e-4
        r[1, hum, cat] = 7.0 * Dc
        r[1, hum, prev] = 4.0e-6
        r[1, prev, cat] = 0.5 * Dc
        r[1, srev, cat] = 0.05 * Dc
        r[1, an, pol] = 5.0e-6
        r[1, pol, an] = 12.0 * Dc
        r[1, pol, prev] = 2.4e-5
        r[2, cat, hum] = 8.0e-6
        r[2, cat, prev] = 2.0e-6
        r[2, cat, pol] = 1.4e-4
        r[2, hum, cat] = 7.0 * Dc
        r[2, hum, prev] = 6.0e-6
        r[2, prev, cat] = 0.6 * Dc
        r[2, srev, cat] = 0.06 * Dc
        r[2, an, pol] = 5.0e-6
        r[2, pol, an] = 12.0 * Dc
        r[2, pol, prev] = 6.0e-5
        r[3, cat, hum] = 6.0e-6
        r[3, cat, prev] = 1.8e-6
        r[3, cat, pol] = 1.5e-4
        r[3, hum, cat] = 7.0 * Dc
        r[3, hum, prev] = 1.0e-5
        r[3, prev, cat] = 0.8 * Dc
        r[3, srev, cat] = 0.08 * Dc
        r[3, an, pol] = 5.0e-6
        r[3, pol, an] = 12.0 * Dc
        r[3, pol, prev] = 8.0e-5
        return r

    # --------------------------------------------------------- seeding ----
    def seed_elements(self, *args, **kwargs):
        """Split the release between LMM and particle species
        (reference radionuclides.py:349-480)."""
        number = kwargs.get("number")
        if number is None:
            number = int(self.get_config("seed:number"))
        if "specie" not in kwargs:
            lmm_f = self.get_config("seed:LMM_fraction")
            n_lmm = int(round(number * lmm_f))
            specie = np.zeros(number, dtype=np.int32)
            specie[n_lmm:] = self.specie_name2num("Particle reversible")
            kwargs["specie"] = specie
        if "diameter" not in kwargs:
            dia = self.get_config("radionuclide:particle_diameter")
            unc = self.get_config(
                "radionuclide:particle_diameter_uncertainty")
            d = np.abs(self._np_random.normal(dia, unc, number))
            d[np.asarray(kwargs["specie"]) == 0] = 0.0
            kwargs["diameter"] = d
        return super().seed_elements(*args, **kwargs)

    # ---------------------------------------------------------- physics ---
    def update_terminal_velocity(self, ctx, **kwargs):
        """Stokes sinking for particle-bound species
        (reference radionuclides.py:640-700)."""
        d = ctx.state.data
        T0 = ctx.environment["sea_water_temperature"]
        S0 = ctx.environment["sea_water_salinity"]
        rho_w = ph.sea_water_density(T0, S0)
        mu_w = ph.sea_water_dynamic_viscosity(T0, S0)
        # per-element particle density (reference radionuclides.py:712)
        w = -(d["density"] - rho_w) * G * d["diameter"] ** 2 / (18.0 * mu_w)
        is_particle = self._is_particle_specie(d["specie"])
        ctx.set_var("terminal_velocity", torch.where(is_particle, w, 0.0))

    def terminal_velocity_inner(self, ctx, z, Tprof, Sprof,
                                mix=None):
        return ctx.state.data["terminal_velocity"]

    def _species_mask(self, specie, prefix):
        mask = torch.zeros_like(specie, dtype=torch.bool)
        for i, n in enumerate(self.name_species):
            if n.startswith(prefix):
                mask = mask | (specie == i)
        return mask

    def _is_particle_specie(self, specie):
        return self._species_mask(specie, "Particle")

    def _is_sediment_specie(self, specie):
        return self._species_mask(specie, "Sediment")

    def update_speciation(self, ctx):
        """Environment-modulated stochastic speciation
        (reference radionuclides.py:728-810)."""
        d = ctx.state.data
        rates = np.asarray(self.transfer_rates_matrix())
        rates, edges = on_device(self, d["z"].device, rates, np.asarray(
            getattr(self, "salinity_intervals", ()), np.float32))
        specie = d["specie"].long()
        if rates.ndim == 3:
            # Al colloid chemistry: per-element salinity band
            # (reference update_transfer_rates, radionuclides.py:753-757)
            sal = ctx.environment["sea_water_salinity"]
            sali = torch.clip(torch.searchsorted(edges, sal, right=True) - 1,
                              0, rates.shape[0] - 1)
            row = rates[sali, specie]                  # (N, S)
        else:
            row = rates[specie]                        # (N, S)
            lmm = self.specie_name2num("LMM")
            srev = self.specie_name2num("Sediment reversible")
            prev = self.specie_name2num("Particle reversible")
            # LMM -> sediment only near the seabed
            thick = self.get_config("radionuclide:sediment:layer_thick")
            dist = d["z"] \
                + ctx.environment["sea_floor_depth_below_sea_level"]
            far = (d["specie"] == lmm) & (dist > thick)
            row[:, srev] = torch.where(far, 0.0, row[:, srev])
            # adsorption scaled by local suspended particle concentration
            conc3 = ctx.environment["conc3"]
            is_lmm = d["specie"] == lmm
            row[:, prev] = torch.where(is_lmm, row[:, prev] * conc3 / 1.0e-3,
                                       row[:, prev])

        new_specie, transformed = speciation_step(
            d["specie"], row, ctx.params["dt"], ctx.next_key(), ctx.active)

        # sorption to sediments: drop to seabed, freeze
        # (reference radionuclides.py:817-838)
        to_sed = transformed & self._is_sediment_specie(new_specie) \
            & ~self._is_sediment_specie(d["specie"])
        depth = ctx.environment["sea_floor_depth_below_sea_level"]
        z = torch.where(to_sed, -depth, d["z"])
        moving = torch.where(to_sed, 0.0, d["moving"])
        # desorption from sediments: lift off the bed, unfreeze
        # (reference radionuclides.py:840-870)
        from_sed = transformed & self._is_sediment_specie(d["specie"]) \
            & ~self._is_sediment_specie(new_specie)
        lift = self.get_config("radionuclide:sediment:desorption_depth")
        unc = self.get_config(
            "radionuclide:sediment:desorption_depth_uncert")
        shape = tuple(z.shape)
        noise = rng.normal(ctx.next_key(), shape, z.device) * unc
        z = torch.where(from_sed, -depth + lift + noise, z)
        moving = torch.where(from_sed, 1.0, moving)
        z = torch.clamp_max(z, 0.0)

        # diameter changes with specie (reference radionuclides.py:872-905)
        dia = self.get_config("radionuclide:particle_diameter")
        dunc = self.get_config(
            "radionuclide:particle_diameter_uncertainty")
        newdia = torch.abs(dia + rng.normal(ctx.next_key(), shape, z.device)
                           * dunc)
        to_particle = transformed & self._is_particle_specie(new_specie)
        to_diss = transformed & ~self._is_particle_specie(new_specie) \
            & ~self._is_sediment_specie(new_specie)
        diameter = torch.where(to_particle, newdia, d["diameter"])
        diameter = torch.where(to_diss, 0.0, diameter)

        ctx.set_var("specie", new_specie, mask=ctx.active)
        ctx.set_var("z", z)
        ctx.set_var("moving", moving)
        ctx.set_var("diameter", diameter)

    def bottom_interaction(self, ctx, mix, zmin):
        """Particles resting on the seafloor stop (await resuspension via
        desorption); reference radionuclides.py:1010-1030."""
        d = ctx.state.data
        at_bottom = (mix["z"] <= zmin) & self._is_particle_specie(
            d["specie"])
        mix["moving"] = torch.where(at_bottom, 0.0, mix["moving"])
        return mix

    def update(self, ctx):
        """(reference radionuclides.py:1035-1060)."""
        self.update_speciation(ctx)
        self.resuspension(ctx)
        ctx.advect_ocean_current()
        self.update_terminal_velocity(ctx)
        if self.get_config("drift:vertical_mixing"):
            self.vertical_mixing(ctx)
        else:
            self.vertical_buoyancy(ctx)
        self.vertical_advection(ctx)

    # ------------------------------------------------------- diagnostics --
    def resuspension(self, ctx):
        """Resuspension of sedimented radionuclides above a critical
        near-bottom speed (reference radionuclides.py resuspension)."""
        resuspend(ctx, self.specie_name2num("Sediment reversible"),
                  self.specie_name2num("Particle reversible"),
                  self.get_config(
                      "radionuclide:sediment:resuspension_critvel"),
                  self.get_config("radionuclide:sediment:resuspension_depth"),
                  self.get_config(
                      "radionuclide:sediment:resuspension_depth_uncert"))

    def specie_num2name(self, num):
        return self.name_species[num]

    def get_radionuclide_density_array(self, pixelsize_m, zlevels):
        """Per-specie per-depth-layer element counts on a lon/lat grid
        (reference radionuclides.py get_radionuclide_density_array)."""
        from .chemicaldrift import ChemicalDrift
        return ChemicalDrift.get_chemical_density_array(
            self, pixelsize_m, zlevels, weight=None)

    def write_netcdf_radionuclide_density_map(
            self, filename, pixelsize_m=1000.0, zlevels=(-5.0,),
            horizontal_smoothing=False, smoothing_cells=1):
        """Gridded radionuclide density map per specie and depth layer
        (reference radionuclides.py:1300-1400)."""
        from scipy.io import netcdf_file
        from .chemicaldrift import ChemicalDrift
        H, lonbin, latbin, bounds = self.get_radionuclide_density_array(
            pixelsize_m, zlevels)
        if horizontal_smoothing:
            H = ChemicalDrift.horizontal_smooth(H, smoothing_cells)
        lon_c = 0.5 * (lonbin[:-1] + lonbin[1:])
        lat_c = 0.5 * (latbin[:-1] + latbin[1:])
        times = self.result.coords["time"].astype("datetime64[s]")
        secs = (times - np.datetime64("1970-01-01T00:00:00", "s")
                ).astype("float64")
        f = netcdf_file(filename, "w", version=2)
        try:
            f.createDimension("time", H.shape[0])
            f.createDimension("specie", H.shape[1])
            f.createDimension("depth", H.shape[2])
            f.createDimension("lon", len(lon_c))
            f.createDimension("lat", len(lat_c))
            v = f.createVariable("time", "d", ("time",))
            v[:] = secs
            v.units = "seconds since 1970-01-01 00:00:00"
            v = f.createVariable("depth", "f", ("depth",))
            v[:] = -np.asarray(bounds[:-1], np.float32)
            v.units = "m"
            v = f.createVariable("lon", "d", ("lon",))
            v[:] = lon_c
            v.units = "degrees_east"
            v = f.createVariable("lat", "d", ("lat",))
            v[:] = lat_c
            v.units = "degrees_north"
            v = f.createVariable("density", "f",
                                 ("time", "specie", "depth", "lon",
                                  "lat"))
            v[:] = H.astype(np.float32)
            v.units = "1"
            v.long_name = "Number of elements; species " \
                + ", ".join(self.name_species)
            f.flush()
        finally:
            f.close()

    # --------------------------------------------------- GUI post-processing
    def gui_postproc(self, filename=None, pixelsize_m=200.0):
        """GUI hook run after a simulation: log the final speciation and
        save the concentration file (reference radionuclides.py:1559-1572
        ``gui_postproc``)."""
        import os
        logger.info("Postprocessing radionuclides")
        specie = np.asarray(self.result["specie"].values)[:, -1]
        logger.info("Final speciation:")
        for i, sp in enumerate(self.name_species):
            logger.info("%32s: %6d", sp, int((specie == i).sum()))
        if filename is None:
            filename = os.path.join(os.path.expanduser("~"),
                                    "conc_radio_gui.nc")
        self.guipp_saveconcfile(filename, pixelsize_m=pixelsize_m)
        return filename

    def guipp_saveconcfile(self, filename, pixelsize_m=200.0,
                           zlevels=None):
        """Save the gridded concentration NetCDF (reference
        radionuclides.py:1587-1619 ``guipp_saveconcfile``)."""
        if zlevels is None:
            zlevels = (-1.0, -10.0, -50.0)
        self.write_netcdf_radionuclide_density_map(
            filename, pixelsize_m=pixelsize_m, zlevels=tuple(zlevels),
            horizontal_smoothing=True, smoothing_cells=1)
        logger.info("Saved radionuclide concentration map to %s",
                    filename)

    def guipp_showanimationprofile(self, filename=None, **kwargs):
        """Profile animation coloured by specie with a categorical legend
        (reference radionuclides.py:1622-1628)."""
        return self.animation_profile(
            filename=filename, color="specie", vmin=0,
            vmax=self.nspecies - 1,
            legend=[self.specie_num2name(i)
                    for i in range(self.nspecies)],
            legend_loc=3, **kwargs)

    def guipp_plotandsaveconc(self, filename, outfilename, zlayers=None,
                              specie=None):
        """Per-specie concentration maps from a saved density file, one PNG
        per (specie, layer, time) (reference radionuclides.py:1635-1740
        ``guipp_plotandsaveconc``; plain matplotlib, no cartopy)."""
        from scipy.io import netcdf_file
        use_agg()
        plt = pyplot()
        if zlayers is None:
            zlayers = [0]
        if specie is None:
            specie_arr = ["Total"] + list(self.name_species[:2])
        else:
            specie_arr = list(specie)
        f = netcdf_file(filename, "r", mmap=False)
        try:
            dens = np.asarray(f.variables["density"][:])  # (t,s,z,lon,lat)
            lon = np.asarray(f.variables["lon"][:])
            lat = np.asarray(f.variables["lat"][:])
        finally:
            f.close()
        written = []
        for sp in specie_arr:
            if sp == "Total":
                field_t = dens.sum(axis=1)
            else:
                field_t = dens[:, self.specie_name2num(sp)]
            for zi in zlayers:
                for ti in range(field_t.shape[0]):
                    fig, ax = plt.subplots()
                    im = ax.pcolormesh(lon, lat, field_t[ti, zi].T,
                                       cmap="CMRmap_r", shading="auto")
                    plt.colorbar(im, ax=ax, label="elements")
                    ax.set_title(f"{sp}  layer {zi}  frame {ti}")
                    out = f"{outfilename}_{sp.replace(' ', '_')}" \
                          f"_z{zi}_t{ti:03d}.png"
                    fig.savefig(out, dpi=90)
                    plt.close(fig)
                    written.append(out)
        logger.info("Wrote %d concentration plots", len(written))
        return written
