"""OpenOil: oil drift and weathering.

Port of ``opendrift_tpu/models/openoil/openoil.py`` (reference:
opendrift/models/openoil/openoil.py:105-1449 and noaa_oil_weathering.py):
NOAA/PyGNOME-style weathering — per-pseudo-component evaporation,
emulsification water uptake, Roy-constant dispersion, biodegradation —
plus Li (2017) wave entrainment with Johansen (2015)/Li (2017) droplet
spectra inside the vertical-mixing inner loop, Tkalich droplet terminal
velocity, and ice-adjusted advection (Nordam 2019).

As in the JAX package, the per-element (C pseudo-components x N elements)
mass matrix lives in the element state as one (C, N) tensor, the element
axis last, and droplet diameters are drawn from the lognormal volume
distribution in closed form.  The mixing inner loop runs through the fused
oil kernel (``ops/mixing.visser_mixing_oil``; its plain version on the
CPU).  Where that kernel does not apply (a profile diffusivity model, T/S
profiles, ``vertical_mixing:use_pallas=False``, overridden hooks) the step
takes the generic per-substep loop of ``OceanDrift.vertical_mixing`` with
:meth:`OpenOil.surface_wave_mixing`, whose entrainment draws are keyed
otherwise than the kernel's (as in the JAX package: the two paths give
different realisations of the same process).  The satellite seeders
(``seed_from_gml``, ``seed_from_geotiff_thickness``) are host code and draw
what the JAX package draws; the plot helpers import matplotlib when
called.

Float32 throughout: the oil's scalar properties are Python floats, which
never promote a float32 tensor.
"""

import math

import numpy as np
import torch

from ... import rng
from ...config import CONFIG_LEVEL_ESSENTIAL, CONFIG_LEVEL_BASIC, \
    CONFIG_LEVEL_ADVANCED
from ...ops import mixing
from ...ops import physics as ph
from ...parallel.mesh import gathered
from ...utils.plotting import pyplot
from ...utils.shapefile import points_in_ring
from ..oceandrift import OceanDrift, Lagrangian3DArray
from .oil_db import OilType, get_oil_names

G = 9.81
GAS_CONSTANT = 8.314


def _minimum(x, bound):
    """Elementwise minimum of a tensor and a tensor or Python float."""
    if torch.is_tensor(bound):
        return torch.minimum(x, bound)
    return torch.clamp_max(x, bound)


class Oil(Lagrangian3DArray):
    """Oil element (reference openoil.py:105-207)."""

    variables = Lagrangian3DArray.add_variables([
        ("mass_oil", {"dtype": np.float32, "units": "kg", "default": 1.0}),
        ("viscosity", {"dtype": np.float32, "units": "m2/s", "seed": False,
                       "default": 0.005,
                       "description": "Kinematic viscosity of emulsion"}),
        ("density", {"dtype": np.float32, "units": "kg/m^3", "seed": False,
                     "default": 880.0}),
        ("wind_drift_factor", {"dtype": np.float32, "units": "1",
                               "default": 0.03}),
        ("bulltime", {"dtype": np.float32, "units": "s", "seed": False,
                      "default": 0.0}),
        ("interfacial_area", {"dtype": np.float32, "units": "m2",
                              "seed": False, "default": 0.0}),
        ("mass_dispersed", {"dtype": np.float32, "units": "kg",
                            "seed": False, "default": 0.0}),
        ("mass_evaporated", {"dtype": np.float32, "units": "kg",
                             "seed": False, "default": 0.0}),
        ("mass_biodegraded", {"dtype": np.float32, "units": "kg",
                              "seed": False, "default": 0.0}),
        ("biodegradation_half_time_droplet", {
            "dtype": np.float32, "units": "Days", "default": 1.0}),
        ("biodegradation_half_time_slick", {
            "dtype": np.float32, "units": "Days", "default": 3.0}),
        ("fraction_evaporated", {"dtype": np.float32, "units": "1",
                                 "seed": False, "default": 0.0}),
        ("water_fraction", {"dtype": np.float32, "units": "1",
                            "seed": False, "default": 0.0}),
        ("oil_film_thickness", {"dtype": np.float32, "units": "m",
                                "default": 0.001}),
        ("diameter", {"dtype": np.float32, "units": "m", "default": 0.0}),
    ])


class OpenOil(OceanDrift):
    """Oil drift + weathering model (reference openoil.py:210)."""

    ElementType = Oil

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "upward_sea_water_velocity": {
            "fallback": 0, "skip_if": ["drift:vertical_advection", "is",
                                       False]},
        "sea_surface_height": {"fallback": 0},
        "sea_surface_wave_significant_height": {"fallback": 0},
        "sea_surface_wave_stokes_drift_x_velocity": {"fallback": 0},
        "sea_surface_wave_stokes_drift_y_velocity": {"fallback": 0},
        "sea_surface_wave_period_at_variance_spectral_density_maximum":
            {"fallback": 0},
        "sea_surface_wave_mean_period_from_variance_spectral_density_"
        "second_frequency_moment": {"fallback": 0},
        "sea_ice_area_fraction": {"fallback": 0},
        "sea_ice_x_velocity": {"fallback": 0},
        "sea_ice_y_velocity": {"fallback": 0},
        "sea_water_temperature": {"fallback": 10, "profiles": True,
            "profiles_if": ["vertical_mixing:TSprofiles", "is", True]},
        "sea_water_salinity": {"fallback": 34.0, "profiles": True,
            "profiles_if": ["vertical_mixing:TSprofiles", "is", True]},
        "sea_floor_depth_below_sea_level": {"fallback": 10000},
        "ocean_vertical_diffusivity": {
            "fallback": 0.02, "profiles": True,
            "profiles_if": ["vertical_mixing:diffusivitymodel", "is",
                            "environment"],
            "skip_if": ["drift:vertical_mixing", "is", False]},
        "ocean_mixed_layer_thickness": {"fallback": 50},
        "land_binary_mask": {"fallback": None},
    }

    def add_config(self):
        super().add_config()
        oil_names = get_oil_names()
        self._add_config({
            "seed:oil_type": {
                "type": "enum", "enum": oil_names,
                "default": "GENERIC MEDIUM CRUDE",
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Oil type from the bundled NOAA/ADIOS-"
                "derived database"},
            "seed:m3_per_hour": {
                "type": "float", "default": 1.0, "min": 0, "max": 1e10,
                "units": "m3 per hour", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Oil discharge rate for cone seeding"},
            "processes:dispersion": {
                "type": "bool", "default": True, "level": CONFIG_LEVEL_BASIC,
                "description": "Wave-induced natural dispersion"},
            "processes:evaporation": {
                "type": "bool", "default": True, "level": CONFIG_LEVEL_BASIC,
                "description": "Evaporation of light pseudo-components"},
            "processes:emulsification": {
                "type": "bool", "default": True, "level": CONFIG_LEVEL_BASIC,
                "description": "Water uptake (mousse formation)"},
            "processes:biodegradation": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_BASIC,
                "description": "Microbial degradation of oil mass"},
            "biodegradation:method": {
                "type": "enum", "enum": ["Adcroft", "half_time"],
                "default": "Adcroft", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Biodegradation parameterisation"},
            "processes:update_oilfilm_thickness": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Recompute slick thickness from the binned "
                "surface mass distribution each step"},
            "wave_entrainment:droplet_size_distribution": {
                "type": "enum",
                "enum": ["Johansen et al. (2015)", "Li et al. (2017)"],
                "default": "Johansen et al. (2015)",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Droplet spectrum at wave entrainment"},
            "wave_entrainment:entrainment_rate": {
                "type": "enum", "enum": ["Li et al. (2017)"],
                "default": "Li et al. (2017)",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Oil wave entrainment rate formulation"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("drift:vertical_advection", False)
        self._set_config_default("drift:vertical_mixing", True)
        self._set_config_default("drift:vertical_mixing_at_surface", False)
        self._set_config_default("drift:current_uncertainty", 0.05)
        self._set_config_default("drift:wind_uncertainty", 0.5)
        self._set_config_default("drift:max_speed", 1.3)
        self.oiltype = None
        self.keep_droplet_diameter = False

    # --------------------------------------------------------- seeding ----
    def set_oiltype(self, oiltype):
        """Select the oil by name or pre-built OilType (reference
        openoil.py set_oiltype/set_oiltype_by_id)."""
        if isinstance(oiltype, OilType):
            self.oiltype = oiltype
            self.oil_name = oiltype.name
        else:
            self.set_config("seed:oil_type", oiltype)
            self.oiltype = OilType(oiltype)
            self.oil_name = self.oiltype.name

    def get_oil_name(self):
        return getattr(self, "oil_name", None) \
            or self.get_config("seed:oil_type")

    def seed_elements(self, *args, oil_type=None, **kwargs):
        if oil_type is not None:
            self.set_config("seed:oil_type", oil_type)
        if self.oiltype is None or oil_type is not None:
            self.oiltype = OilType(self.get_config("seed:oil_type"))
        self.oil_name = self.oiltype.name
        # initial density/viscosity at 15 C from the oil database
        kwargs.setdefault("density",
                          float(self.oiltype.density_at_temp(288.15)))
        kwargs.setdefault("viscosity",
                          float(self.oiltype.kvis_at_temp(288.15)))
        # oil mass per element from the discharge rate when not given
        # explicitly (reference openoil.py:1737-1754): volume rate x
        # release duration x density / number
        m3_per_hour = kwargs.pop("m3_per_hour", None)
        if "mass_oil" not in kwargs:
            if m3_per_hour is None:
                m3_per_hour = self.get_config("seed:m3_per_hour")
            lon = args[0] if args else kwargs.get("lon", 0.0)
            number = self._seed_count(lon, kwargs.get("z", 0.0),
                                      kwargs.get("number"))
            number = int(np.sum(number))   # arrays seed per-point counts
            time = kwargs.get("time")
            if isinstance(time, (list, tuple)) and len(time) == 2:
                duration_hours = (time[1] - time[0]).total_seconds() \
                    / 3600.0
                if duration_hours == 0:
                    duration_hours = 1.0
            else:
                duration_hours = 1.0   # instantaneous spill
            kwargs["mass_oil"] = (m3_per_hour * duration_hours
                                  / max(number, 1) * kwargs["density"])
        return super().seed_elements(*args, **kwargs)

    def _build_initial_state(self, dt):
        arrays = super()._build_initial_state(dt)
        if self.oiltype is None:
            self.oiltype = OilType(self.get_config("seed:oil_type"))
        # per-element pseudo-component mass matrix (C, N)
        mf = self.oiltype.mass_fraction.astype(np.float32)
        arrays["mass_components"] = \
            mf[:, None] * arrays["mass_oil"][None, :]
        self.oil_water_interfacial_tension = \
            self.oiltype.oil_water_surface_tension()
        self._molecular_weight = torch.as_tensor(
            self.oiltype.molecular_weight, device=self.device)
        return arrays

    # ------------------------------------------------------- weathering ---
    def oil_weathering(self, ctx):
        """NOAA weathering scheme (reference openoil.py:717-790)."""
        if ctx.params["dt"] < 0:
            return
        d = ctx.state.data
        T_K = ctx.environment["sea_water_temperature"] + 273.15

        oil_viscosity = self.oiltype.kvis_at_temp(T_K)
        oil_density = self.oiltype.density_at_temp(T_K)

        # emulsion density and viscosity (reference openoil.py:741-760)
        rho_w = ctx.sea_water_density()
        density = d["water_fraction"] * rho_w \
            + (1.0 - d["water_fraction"]) * oil_density
        visc_f_ref = 0.84
        fw_d_fref = d["water_fraction"] / visc_f_ref
        kv1 = torch.clip(torch.sqrt(oil_viscosity) * 1.5e3, 1.0, 10.0)
        total = d["mass_oil"] + d["mass_evaporated"]
        frac_evap = torch.where(total > 0, d["mass_evaporated"] / total, 0.0)
        viscosity = (oil_viscosity * torch.exp(kv1 * frac_evap)
                     * (1.0 + fw_d_fref / (1.187 - fw_d_fref)) ** 2.49)
        ctx.set_var("density", density)
        ctx.set_var("viscosity", viscosity)
        ctx.set_var("fraction_evaporated", frac_evap)

        if self.get_config("processes:evaporation"):
            self.evaporation_noaa(ctx, T_K)
        if self.get_config("processes:emulsification"):
            self.emulsification_noaa(ctx)
        if self.get_config("processes:dispersion"):
            self.disperse_noaa(ctx)
        if self.get_config("processes:biodegradation"):
            self.biodegradation(ctx)

    def evaporation_noaa(self, ctx, T_K):
        """Pseudo-component evaporation for surface slicks
        (reference openoil.py:822-853, noaa_oil_weathering.py:10-33)."""
        d = ctx.state.data
        dt = ctx.params["dt"]
        mass_components = d["mass_components"]          # (C, N)
        surface = ctx.active & (d["z"] == 0.0) \
            & (d["age_seconds"] <= 3600.0 * 24)
        wind = ctx.wind_speed()
        # mass transport coefficient
        c_evap = 0.0025
        K = torch.where(wind >= 10.0,
                        0.06 * c_evap * (wind * wind),
                        c_evap * wind ** 0.78)
        volume = d["mass_oil"] / torch.clamp_min(d["density"], 1.0)
        area = volume / torch.clamp_min(d["oil_film_thickness"], 1e-9)
        vp = self.oiltype.vapor_pressure(T_K)            # (C, N)
        mw = self._molecular_weight                      # already kg/mol
        sum_mi_mw = torch.sum(mass_components / mw[:, None], dim=0)
        decay = (-(area * K) / (GAS_CONSTANT * T_K
                                * torch.clamp_min(sum_mi_mw, 1e-12)))[None, :] \
            * vp
        remain = mass_components * torch.exp(decay * dt)
        remain = torch.where(surface[None, :], remain, mass_components)
        evap_now = torch.sum(mass_components - remain, dim=0)
        ctx.state = ctx.state.replace(
            mass_components=remain,
            mass_evaporated=d["mass_evaporated"] + evap_now,
            mass_oil=torch.where(surface, torch.sum(remain, dim=0),
                                 d["mass_oil"]))

    def emulsification_noaa(self, ctx):
        """Water uptake / mousse formation
        (reference openoil.py:855-920)."""
        d = ctx.state.data
        dt = ctx.params["dt"]
        ot = self.oiltype
        emul_time = ot.bullwinkle_time
        emul_c = ot.bullwinkle_fraction
        start = ((d["age_seconds"] >= emul_time) & (emul_time >= 0)) | \
            ((d["fraction_evaporated"] >= emul_c) & (emul_c > 0))
        start = start & ctx.active

        Y_max = ot.emulsion_water_fraction_max
        if ot.max_water_fraction_sintef:
            wf = ot.max_water_fraction_sintef["max_water_fraction"]
            wft = ot.max_water_fraction_sintef["temperatures"]
            if len(wf) == 1:
                wf = [wf[0], wf[0]]
                wft = [wft[0], wft[0] + 1e-3]
            swt = ctx.environment["sea_water_temperature"]
            weights = torch.clip((wft[1] - swt) / (wft[1] - wft[0]), 0.0, 1.0)
            y_sintef = weights * wf[0] + (1.0 - weights) * wf[1]
            Y_max = torch.clamp_max(y_sintef, Y_max)
        # a host test, as in the JAX package: with temperature-dependent
        # SINTEF data Y_max is a device tensor, and reading its maximum
        # waits for the device once a step
        if (float(gathered(Y_max).max()) if torch.is_tensor(Y_max)
                else Y_max) <= 0:
            return
        drop_min, drop_max = 1.0e-6, 1.0e-5
        S_max = (6.0 / drop_min) * (Y_max / (1.0 - Y_max))
        start_time = torch.where(d["bulltime"] > 0, d["bulltime"],
                                 d["age_seconds"])
        # water uptake coefficient (noaa_oil_weathering.py:36-42)
        K0Y = 2.024e-6
        wind = ctx.wind_speed()
        k_emul = 6.0 * K0Y * (wind * wind) / drop_max
        area = d["interfacial_area"] + \
            k_emul * abs(dt) * torch.exp(
                (-k_emul / S_max) * (d["age_seconds"] - start_time))
        area = _minimum(area, S_max)
        area = torch.where(start, area, d["interfacial_area"])
        wf_new = area * drop_max / (6.0 + area * drop_max)
        wf_new = _minimum(wf_new, Y_max)
        ctx.set_var("interfacial_area", area)
        ctx.set_var("water_fraction",
                    torch.where(start, wf_new, d["water_fraction"]))

    def disperse_noaa(self, ctx):
        """Natural dispersion (reference openoil.py:612-641, the
        PyGnome formulation): dissipation from Hs (parameterised from
        wind when no wave field), a CONSTANT breaking-wave fraction of
        0.02 (the reference hard-codes it here, independent of its
        dynamic wave_breaking_fraction used for entrainment), Roy's
        viscosity constant — applied to EVERY active element
        regardless of depth, exactly as the reference does."""
        d = ctx.state.data
        dt = abs(ctx.params["dt"])
        rho_sw = 1028.0          # reference's constant, not ctx density
        hs = ctx.significant_wave_height()
        wind = ctx.wind_speed()
        hs = torch.where(hs == 0.0, 0.0246 * (wind * wind), hs)
        dissipation = 0.0034 * rho_sw * 9.81 * (hs * hs)
        c_disp = dissipation ** 0.57 * 0.02
        C_Roy = 2400.0 * torch.exp(
            -73.682 * torch.sqrt(d["viscosity"] / d["density"]))
        v_entrain = 3.9e-8
        q_disp = C_Roy * c_disp * v_entrain / d["density"]
        frac = torch.clip(q_disp * dt * d["density"], 0.0, 0.99)
        frac = torch.where(ctx.active, frac, 0.0)
        loss = frac * d["mass_oil"]
        ctx.state = ctx.state.replace(
            mass_components=d["mass_components"] * (1.0 - frac)[None, :],
            mass_oil=d["mass_oil"] - loss,
            mass_dispersed=d["mass_dispersed"] + loss)

    def biodegradation(self, ctx):
        """(reference openoil.py:582-635)."""
        d = ctx.state.data
        age0 = abs(ctx.params["dt"]) / (3600.0 * 24)
        method = self.get_config("biodegradation:method")
        if method == "half_time":
            half_time = torch.where(d["z"] == 0.0,
                                    d["biodegradation_half_time_slick"],
                                    d["biodegradation_half_time_droplet"])
            frac = 1.0 - torch.exp(-age0 / torch.clamp_min(half_time, 1e-6))
        else:  # Adcroft
            swt = ctx.environment["sea_water_temperature"]
            tau = 12.0 * 3.0 ** ((20.0 - swt) / 10.0)
            frac = 1.0 - torch.exp(-age0 / tau)
        frac = torch.where(ctx.active, frac, 0.0)
        loss = d["mass_oil"] * frac
        ctx.state = ctx.state.replace(
            mass_components=d["mass_components"] * (1.0 - frac)[None, :],
            mass_oil=d["mass_oil"] - loss,
            mass_biodegraded=d["mass_biodegraded"] + loss)

    # ------------------------------------------- entrainment / mixing -----
    def oil_wave_entrainment_rate(self, ctx):
        """Li et al. (2017) entrainment rate
        (reference physics_methods.py:115-137)."""
        d = ctx.state.data
        sigma = self.oil_water_interfacial_tension
        rho_w = ctx.sea_water_density()
        delta_rho = torch.clamp_min(rho_w - d["density"], 1.0)
        d_o = 4.0 * torch.sqrt(sigma / (delta_rho * G))
        hs = ctx.significant_wave_height()
        we = rho_w * G * hs * d_o / sigma
        mu_oil = d["viscosity"] * d["density"]
        oh = mu_oil / torch.sqrt(d["density"] * sigma * d_o)
        fbw = ph.wave_breaking_fraction(ctx.wind_speed(), ctx.wave_period())
        return 4.604e-10 * we ** 1.805 * oh ** -1.023 * fbw

    def _droplet_diameter_distribution(self, ctx):
        """(dV_50 scalar, Sd) of the lognormal droplet volume spectrum
        (reference openoil.py:1066-1180).  dV_50 is the mean over the
        active elements, as upstream takes it over its element arrays,
        which hold only the oil in the water (not the oil yet to be
        released, nor the stranded); with no active element, over all of
        them.  The sum's order differs between devices and libraries
        (agreement to float32 rounding, not to the bit)."""
        d = ctx.state.data
        sigma = self.oil_water_interfacial_tension
        rho_w = ctx.sea_water_density()
        hs = torch.clamp_min(ctx.significant_wave_height(), 0.01)
        sd = 0.4
        Sd = math.log(10.0) * sd
        scheme = self.get_config("wave_entrainment:droplet_size_distribution")
        if scheme == "Li et al. (2017)":
            delta_rho = torch.clamp_min(rho_w - d["density"], 1.0)
            d_o = 4.0 * torch.sqrt(sigma / (delta_rho * G))
            we = rho_w * G * hs * d_o / sigma
            oh = d["viscosity"] * d["density"] * (
                d["density"] * sigma * d_o) ** -0.5
            dV_50 = d_o * 1.791 * (1.0 + 10.0 * oh) ** 0.460 * we ** -0.518
        else:  # Johansen et al. (2015)
            h = torch.clamp_min(d["oil_film_thickness"], 1e-9)
            re = (d["density"] * h * torch.sqrt(G * hs)) \
                / (d["viscosity"] * d["density"])
            we = d["density"] * h * G * hs / sigma
            A, Bp = 2.251, 0.027
            dN_50 = A * h * we ** -0.6 + A * Bp * h * re ** -0.6
            dV_50 = torch.exp(torch.log(dN_50) + 3.0 * Sd ** 2)
        return self._mean_median_diameter(dV_50, ctx), Sd

    def _mean_median_diameter(self, dV_50, ctx):
        """The mean of the elements' median diameters ``dV_50`` across the
        active elements (all tiles' of a particle-sharded run: one gather
        of both rows); with no active element, across all of them."""
        dV_all, active = gathered(torch.stack(
            [dV_50, ctx.active.to(dV_50.dtype)]))
        use = (active > 0) & ~torch.isnan(dV_all)
        count = use.sum()
        mean = torch.where(use, dV_all, 0.0).sum() / count
        return torch.where(count > 0, mean, torch.nanmean(dV_all))

    def prepare_vertical_mixing(self, ctx):
        """Entrainment probability + per-element candidate droplet size
        (reference openoil.py:1017-1031)."""
        dt_mix = float(self.get_config("vertical_mixing:timestep"))
        rate = self.oil_wave_entrainment_rate(ctx)
        ctx._oil_entrainment_probability = 1.0 - torch.exp(-rate * dt_mix)
        dV_50, Sd = self._droplet_diameter_distribution(ctx)
        z = ctx.state.data["z"]
        draw = rng.normal(ctx.next_key(), tuple(z.shape), z.device)
        diam = torch.exp(torch.log(dV_50) + Sd * draw)
        ctx._droplet_diameter_if_entrained = torch.clip(diam, 1e-6, 3e-3)

    def mixing_carry_extra(self, ctx):
        return {"diameter": ctx.state.data["diameter"]}

    def _mixing_fast_path(self, ctx, model, ntimes, dt_mix, zmin, moving,
                          extra, store_depths, has_TS_profiles):
        """The fused inner loop of the oil mixing cycle: Visser walk +
        Tkalich rise + wave entrainment in one kernel
        (ops/mixing.visser_mixing_oil).  Returns False when profiles,
        hook overrides or ``vertical_mixing:use_pallas=False`` make the
        kernel invalid; the caller then takes the generic loop."""
        cls = type(self)
        if (store_depths or has_TS_profiles
                or set(extra) != {"diameter"}
                or model not in mixing.WINDSPEED_MODELS
                or cls.surface_stick is not OceanDrift.surface_stick
                or cls.bottom_interaction is not OceanDrift.bottom_interaction
                or cls.surface_wave_mixing is not OpenOil.surface_wave_mixing
                or cls.terminal_velocity_inner
                is not OpenOil.terminal_velocity_inner
                or not self.get_config("vertical_mixing:use_pallas",
                                       default=True)):
            self.count("oil.mixing_generic_steps")
            return False

        d = ctx.state.data
        # z-independent Tkalich factors at the held T/S
        T0 = ctx.environment["sea_water_temperature"]
        S0 = ctx.environment["sea_water_salinity"]
        rho_w = ph.sea_water_density(T0, S0)
        mu_w = ph.sea_water_dynamic_viscosity(T0, S0)
        nu_w = mu_w / rho_w
        rhopr = d["density"] / rho_w
        g = 9.81
        kw = 2.0 * g * (1.0 - rhopr) / (9.0 * nu_w)
        kw2 = torch.sqrt(torch.abs(16.0 * g * (1.0 - rhopr) / 3.0)) \
            * torch.sign(1.0 - rhopr)
        zb = 1.5 * ctx.significant_wave_height()

        # the third key of the step: after the candidate diameters' and
        # the base key of vertical_mixing, as in the JAX package
        seed = rng.bits(ctx.next_key())
        z_out, diam_out = mixing.visser_mixing_oil(
            d["z"], d["diameter"], moving, ctx.wind_speed(),
            ctx.environment.get("ocean_mixed_layer_thickness",
                                torch.full_like(d["z"], 50.0)),
            zmin, ctx._oil_entrainment_probability,
            ctx._droplet_diameter_if_entrained, zb, kw, kw2, nu_w, seed,
            elem=d["ID"],
            ntimes=ntimes, dt_mix=dt_mix, model=model,
            bg=float(self.get_config(
                "vertical_mixing:background_diffusivity")),
            mixing_at_surface=bool(self.get_config(
                "drift:vertical_mixing_at_surface")),
            keep_diam=bool(self.keep_droplet_diameter))
        active = ctx.active
        ctx.set_var("z", torch.where(active, z_out, d["z"]))
        ctx.set_var("diameter", torch.where(active, diam_out,
                                            d["diameter"]))
        self.count("oil.mixing_fast_path_steps")
        return True

    def surface_wave_mixing(self, ctx, mix, dt_mix, key):
        """Whitecapping entrainment of surface oil in the generic loop
        (reference openoil.py:1033-1056).  Draws are SplitMix32 on the
        element ID, salted with the substep key's bits."""
        z = mix["z"]
        surface = z >= 0.0
        ids = ctx.state.data["ID"].to(torch.int64) & mixing._M32
        salt = rng.bits(key)
        bits1 = mixing.splitmix32(
            (ids + (salt * 0x9e3779b9 & mixing._M32)) & mixing._M32)
        bits2 = mixing.splitmix32((bits1 + 0xc2b2ae35) & mixing._M32)
        entrained = surface & (mixing._unit(bits1)
                               < ctx._oil_entrainment_probability)
        zb = 1.5 * ctx.significant_wave_height()
        mix["z"] = torch.where(entrained, -(mixing._unit(bits2) * zb), z)
        if not self.keep_droplet_diameter:
            mix["diameter"] = torch.where(
                entrained, ctx._droplet_diameter_if_entrained,
                mix["diameter"])
        return mix

    def terminal_velocity_inner(self, ctx, z, Tprof, Sprof, mix=None):
        """Tkalich (2002) oil droplet rise velocity with high-Reynolds
        switch (reference openoil.py:922-998), at the T/S of the profiles
        where they are given."""
        d = ctx.state.data
        if Tprof is not None and Sprof is not None:
            T0 = self.profile_interp(ctx, Tprof, z)
            S0 = self.profile_interp(ctx, Sprof, z)
        else:
            T0 = ctx.environment["sea_water_temperature"]
            S0 = ctx.environment["sea_water_salinity"]
        # inside the mixing loop the diameter is carried and updated on
        # entrainment — use it, not the stale start-of-step value
        r = mix["diameter"] if mix is not None and "diameter" in mix \
            else d["diameter"]
        rho_oil = d["density"]
        rho_w = ph.sea_water_density(T0, S0)
        mu_w = ph.sea_water_dynamic_viscosity(T0, S0)
        nu_w = mu_w / rho_w
        rhopr = rho_oil / rho_w
        kw = 2.0 * G * (1.0 - rhopr) / (9.0 * nu_w)
        r2 = r / 2.0
        W = kw * (r2 * r2)
        Re = r * torch.abs(W) / nu_w
        kw2 = torch.sqrt(torch.abs(16.0 * G * (1.0 - rhopr) / 3.0)) \
            * torch.sign(1.0 - rhopr)
        W2 = kw2 * torch.sqrt(r2)
        return torch.where(Re > 50.0, W2, W)

    def update_terminal_velocity(self, ctx, **kwargs):
        w = self.terminal_velocity_inner(ctx, ctx.state.data["z"], None,
                                         None)
        ctx.set_var("terminal_velocity", w)

    # ------------------------------------------------ film thickness ------
    def update_surface_oilfilm_thickness(self, ctx):
        """Per-cell slick thickness from the binned surface mass
        (reference openoil.py:502-570).  The bin sums are an
        ``index_add_``: on the card its atomic adds come in an order that
        varies from run to run, so a bin's mass, and the thickness from
        it, is reproducible to float32 rounding and not to the bit.  With
        no element at the surface the bounds are +-inf and the thickness
        NaN, which is applied to no element."""
        d = ctx.state.data
        surface = ctx.active & (d["z"] == 0.0)
        lon, lat = d["lon"], d["lat"]
        nb = 100
        inf = float("inf")
        # the slick is every element's: in a particle-sharded run the bins
        # are filled from the whole element axis
        surf_all, lon_all, lat_all, mass_all = (gathered(v) for v in (
            surface, lon, lat, d["mass_oil"]))
        w = torch.where(surf_all, 1.0, 0.0)
        lon0 = torch.min(torch.where(surf_all, lon_all, inf))
        lon1 = torch.max(torch.where(surf_all, lon_all, -inf))
        lat0 = torch.min(torch.where(surf_all, lat_all, inf))
        lat1 = torch.max(torch.where(surf_all, lat_all, -inf))
        dlon = torch.clamp_min(lon1 - lon0, 1e-6)
        dlat = torch.clamp_min(lat1 - lat0, 1e-6)

        def cell(x, x0, dx):
            # clamp before the cast: a float outside int32 has no defined
            # conversion; truncation afterwards gives the same cell
            f = torch.nan_to_num((x - x0) / dx * nb, nan=0.0)
            return torch.clip(f, 0, nb - 1).to(torch.int64)
        bins = cell(lat, lat0, dlat) * nb + cell(lon, lon0, dlon)
        bins_all = cell(lat_all, lat0, dlat) * nb + cell(lon_all, lon0, dlon)
        mass_bin = torch.zeros(nb * nb, dtype=lon.dtype, device=lon.device)
        mass_bin.index_add_(0, bins_all, w * mass_all)
        meanlat = torch.clip(0.5 * (lat0 + lat1), -89.0, 89.0)
        cell_area = (dlon / nb * 111320.0 * torch.cos(torch.deg2rad(meanlat))) \
            * (dlat / nb * 111320.0)
        thickness = (mass_bin / 1000.0) / torch.clamp_min(cell_area, 1.0)
        thickness = torch.clip(thickness, 1e-9, 0.01)
        new_thick = thickness[bins]
        ctx.set_var("oil_film_thickness",
                    torch.where(surface, new_thick, d["oil_film_thickness"]))

    # --------------------------------------------------------- advection --
    def advect_oil(self, ctx):
        """Ice-adjusted advection (Nordam 2019 / Arneborg 2017;
        reference openoil.py:1186-1216)."""
        A = ctx.environment.get("sea_ice_area_fraction")
        if A is not None:
            k_ice = torch.clip((A - 0.3) / (0.8 - 0.3), 0.0, 1.0)
            factor_stokes = torch.clip((0.7 - A) / 0.7, 0.0, 1.0)
        else:
            k_ice = 0.0
            factor_stokes = 1.0
        ctx.advect_ocean_current(factor=1.0 - k_ice)
        ctx.advect_wind(factor=1.0 - k_ice)
        ctx.stokes_drift(factor=factor_stokes)
        if A is not None:
            ctx.advect_with_sea_ice(factor=k_ice)

    # ------------------------------------------------------------- update --
    def vertical_mixing(self, ctx, store_depths=False):
        """OceanDrift's mixing cycle (the entrainment probability, the
        droplet spectrum with its mean, the candidate diameters, then the
        oil kernel or the generic loop) as the span ``main
        loop:advance:oil mixing``."""
        with self.timed("main loop:advance:oil mixing"):
            super().vertical_mixing(ctx, store_depths)

    def update(self, ctx):
        """(reference openoil.py:1218-1243).  The weathering is the span
        ``main loop:advance:weathering``."""
        if self.get_config("processes:update_oilfilm_thickness"):
            self.update_surface_oilfilm_thickness(ctx)
        with self.timed("main loop:advance:weathering"):
            self.oil_weathering(ctx)
        if self.get_config("drift:vertical_mixing"):
            self.update_terminal_velocity(ctx)
            self.vertical_mixing(ctx)
        if self.get_config("drift:vertical_advection"):
            self.vertical_advection(ctx)
        self.advect_oil(ctx)

    # ------------------------------------------------------------ budget --
    def get_oil_budget(self):
        """Mass budget time series from the result dataset
        (reference openoil.py:1241-1340)."""
        ds = self.result
        out = {}
        for key, process in (("mass_evaporated", "evaporation"),
                             ("mass_dispersed", "dispersion"),
                             ("mass_biodegraded", "biodegradation")):
            if key not in ds.variables \
                    and not self.get_config(f"processes:{process}"):
                # not exported, and nothing was lost to the process
                out[key] = np.zeros(len(ds.coords["time"]))
                continue
            vals = np.nan_to_num(np.asarray(ds[key].values), nan=0.0)
            out[key] = vals.sum(axis=0)
        z = np.asarray(ds["z"].values)
        mass = np.nan_to_num(np.asarray(ds["mass_oil"].values), nan=0.0)
        out["mass_submerged"] = np.where(np.nan_to_num(z, nan=0.0) < 0,
                                         mass, 0.0).sum(axis=0)
        out["mass_surface"] = np.where(np.nan_to_num(z, nan=-1) == 0,
                                       mass, 0.0).sum(axis=0)
        out["mass_total"] = (out["mass_surface"] + out["mass_submerged"]
                             + out["mass_evaporated"]
                             + out["mass_dispersed"]
                             + out["mass_biodegraded"])
        return out

    def cumulative_oil_entrainment_fraction(self):
        """Fraction of elements that have (ever) been entrained vs time
        (reference openoil.py:1455-1467)."""
        z = np.asarray(self.result["z"].values)  # (trajectory, time)
        entrained = np.isfinite(z) & (z < 0)
        ever = np.logical_or.accumulate(entrained, axis=1)
        return ever.sum(axis=0) / z.shape[0]

    # ----------------------------------------------- satellite seeding ---
    def seed_from_gml(self, gmlfile, num_elements=1000, **kwargs):
        """Seed oil within the slick polygons of a KSAT-style oil-detection
        GML file (reference openoil.py:1773-1867).  The time is the file's
        ``od:detectionTime``; the points lie on one equal-spacing grid over
        each polygon's bounding box, its spacing chosen so that the count
        over all slicks is about ``num_elements`` (proportional to slick
        area, as the reference does).  The inside test is
        ``utils/shapefile.points_in_ring``, matplotlib's float64 predicate,
        so the points equal the JAX package's."""
        from datetime import datetime as _dt
        from xml.etree import ElementTree

        ns = {"od": "http://cweb.ksat.no/cweb/schema/geoweb/oil",
              "gml": "http://www.opengis.net/gml"}
        tree = ElementTree.parse(gmlfile)
        tpos = "od:oilDetectionMember/od:oilDetection/od:detectionTime"
        oil_time = _dt.strptime(tree.find(tpos, ns).text,
                                "%Y-%m-%dT%H:%M:%S.%fZ")
        ppos = ("od:oilDetectionMember/od:oilDetection/od:oilSpill/"
                "gml:Polygon")
        rpos = "gml:exterior/gml:LinearRing/gml:posList"
        slicks = []
        for patch in tree.findall(ppos, ns):
            c = np.array(patch.find(rpos, ns).text.split(), dtype=float)
            slicks.append((c[0::2], c[1::2]))  # lon, lat
        if not slicks:
            raise ValueError(f"No slick polygons found in {gmlfile}")

        # a local equal-area-ish metric: metres per degree at mean latitude
        lat0 = np.mean([la.mean() for _, la in slicks])
        mx = 111320.0 * np.cos(np.radians(lat0))
        my = 110540.0

        def to_xy(lon, lat):
            return lon * mx, lat * my

        areas = []
        for lon, lat in slicks:
            x, y = to_xy(lon, lat)
            areas.append(abs(np.sum(x * np.roll(y, -1)
                                    - np.roll(x, -1) * y)) / 2.0)
        deltax = np.sqrt(np.sum(areas) / num_elements)
        lons_out, lats_out = [], []
        for lon, lat in slicks:
            x, y = to_xy(lon, lat)
            xv = np.arange(x.min(), x.max(), deltax)
            yv = np.arange(y.min(), y.max(), deltax)
            if len(xv) == 0 or len(yv) == 0:
                continue
            gx, gy = np.meshgrid(xv, yv)
            px, py = gx.ravel() / mx, gy.ravel() / my
            inside = points_in_ring(px, py, np.column_stack([lon, lat]))
            lons_out.append(px[inside])
            lats_out.append(py[inside])
        lons_out = np.concatenate(lons_out)
        lats_out = np.concatenate(lats_out)
        return self.seed_elements(lon=lons_out, lat=lats_out,
                                  number=len(lons_out), time=oil_time,
                                  **kwargs)

    def seed_from_geotiff_thickness(self, filename, number=50000,
                                    **kwargs):
        """Seed oil from a categorical slick-thickness GeoTIFF (categories
        1-4 as provided by C. Hu; reference openoil.py:1869-1958).

        The reference polygonises with GDAL and seeds within the polygons;
        without GDAL the same seeding is done on the pixels: per category
        an element count of about area x thickness, each element placed
        uniformly within a random pixel of that category, drawn from
        ``self._np_random`` in the JAX package's order.
        """
        from datetime import datetime as _dt
        from ...utils.geotiff import read_geotiff

        time = kwargs.pop("time", None)
        if time is None:
            try:
                time = _dt.strptime(filename[-28:-13], "%Y%m%d.%H%M%S")
            except ValueError:
                time = _dt.now()
        data, (lon0, dlon, lat0, dlat) = read_geotiff(filename)
        thickness_microns = np.array([0.04, 0.44, 4.4, 16.0])
        ny, nx = data.shape
        lat_of_row = lat0 + dlat * (np.arange(ny) + 0.5)
        pixel_area = (abs(dlon) * 111320.0
                      * np.cos(np.radians(lat_of_row))[:, None]
                      * abs(dlat) * 110540.0)  # m2, (ny, 1)
        total_area = np.array([
            (pixel_area * (data == cat)).sum() for cat in (1, 2, 3, 4)])
        weighted = total_area * thickness_microns
        if weighted.sum() == 0:
            raise ValueError(f"No slick pixels (categories 1-4) in "
                             f"{filename}")
        numbers = np.round(number * weighted / weighted.sum()).astype(int)
        oil_density = 1000.0
        mass_oil = total_area * thickness_microns / 1e6 * oil_density
        for i, cat in enumerate((1, 2, 3, 4)):
            if numbers[i] == 0:
                continue
            rows, cols = np.nonzero(data == cat)
            pick = self._np_random.randint(0, len(rows), numbers[i])
            jitter = self._np_random.uniform(0, 1, (numbers[i], 2))
            lons = lon0 + dlon * (cols[pick] + jitter[:, 0])
            lats = lat0 + dlat * (rows[pick] + jitter[:, 1])
            self.seed_elements(
                lon=lons, lat=lats, number=int(numbers[i]), time=time,
                oil_film_thickness=float(thickness_microns[i]) / 1e6,
                mass_oil=float(mass_oil[i] / numbers[i]), **kwargs)
        return self

    # ----------------------------------------------------------- plots ---
    def plot_oil_budget(self, filename=None, show=False):
        """Stacked oil mass budget plot (reference openoil.py:1342-1420)."""
        plt = pyplot()
        b = self.get_oil_budget()
        times = np.asarray(self.result.coords["time"]) \
            .astype("datetime64[s]")
        hours = (times - times[0]) / np.timedelta64(1, "h")
        layers = [("mass_dispersed", "Dispersed", "darkslategrey"),
                  ("mass_submerged", "Submerged", "darkblue"),
                  ("mass_surface", "Surface", "royalblue"),
                  ("mass_evaporated", "Evaporated", "skyblue"),
                  ("mass_biodegraded", "Biodegraded", "indianred")]
        fig, ax = plt.subplots(figsize=(9, 5))
        bottom = np.zeros_like(hours, dtype=float)
        for key, label, color in layers:
            vals = np.asarray(b[key], dtype=float)
            ax.fill_between(hours, bottom, bottom + vals,
                            label=label, color=color, alpha=0.85)
            bottom = bottom + vals
        ax.set_xlabel("Time [hours]")
        ax.set_ylabel("Mass oil [kg]")
        ax.set_xlim(hours[0], hours[-1])
        ax.legend(loc="upper left", fontsize=8)
        ax.set_title(f"Oil budget: {getattr(self, 'oil_name', 'oil')}")
        if filename is not None:
            fig.savefig(filename, dpi=120, bbox_inches="tight")
            plt.close(fig)
        elif show:
            plt.show()
        return fig, ax

    def plot_droplet_spectrum(self, filename=None):
        """Histogram of the droplet radii at the last output (reference
        openoil.py:817)."""
        plt = pyplot()
        dia = np.asarray(self.result["diameter"])[:, -1] \
            if self.result is not None and "diameter" in self.result \
            else None
        fig, ax = plt.subplots()
        if dia is not None:
            ax.hist(dia[np.isfinite(dia)] / 2.0, bins=50)
        ax.set_xlabel("Droplet radius [m]")
        ax.set_ylabel("Number")
        if filename:
            fig.savefig(filename, dpi=100)
            plt.close(fig)
        else:
            return fig

    def plot_oil_watercontent_and_viscosity(self, filename=None):
        """Time series of the emulsion's viscosity, density and water
        content (reference openoil.py:1469-1520)."""
        plt = pyplot()
        ds = self.result
        times = np.asarray(ds.coords["time"], dtype="datetime64[s]")
        hours = (times - times[0]) / np.timedelta64(1, "h")
        kin = np.asarray(ds["viscosity"])
        rho = np.asarray(ds["density"])
        dyn = kin * rho * 1000.0                       # mPa s
        wc = np.asarray(ds["water_fraction"]) * 100.0
        fig, axs = plt.subplots(3, 1, sharex=True, figsize=(7, 8))
        for ax, (label, arr) in zip(axs, [
                ("Dynamic viscosity [mPa s]", dyn),
                ("Density [kg/m3]", rho),
                ("Water content [%]", wc)]):
            mean = np.nanmean(arr, axis=0)
            std = np.nanstd(arr, axis=0)
            ax.plot(hours, mean)
            ax.fill_between(hours, mean - std, mean + std, alpha=0.3)
            ax.set_ylabel(label)
        axs[-1].set_xlabel("Hours since start")
        if filename:
            fig.savefig(filename, dpi=100)
            plt.close(fig)
        else:
            return fig
