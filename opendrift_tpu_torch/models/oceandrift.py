"""OceanDrift: generic 3D buoyant tracer model.

Port of ``opendrift_tpu/models/oceandrift.py`` (reference:
opendrift/models/oceandrift.py:54-714): current + wind + Stokes
advection, vertical advection, buoyancy, and Visser (1997) random-walk
vertical mixing.  The mixing inner loop runs through the CUDA kernels of
``ops/mixing.py`` (their plain versions on the CPU): the windspeed
parameterisations through ``visser_mixing``; the profile models,
'constant' and 'environment' with a reader-served
``ocean_vertical_diffusivity``, through ``visser_mixing_profile``; a
subclass can run its own fused kernel through the ``_mixing_fast_path``
hook (OpenOil does, through ``visser_mixing_oil``).  Everything else takes
the generic per-substep loop, a Python loop over the substeps with the
kernels' own draws: ``vertical_mixing:use_pallas=False``, T/S profiles,
and subclasses that override the substep hooks.  A small MLP may add a
residual drift correction each step (``set_ml_correction``).
"""

import logging

import numpy as np
import torch

from .. import rng
from ..elements import LagrangianArray
from ..config import CONFIG_LEVEL_BASIC, CONFIG_LEVEL_ADVANCED, \
    CONFIG_LEVEL_ESSENTIAL
from ..ops import mixing
from ..utils import plotting
from .base import OpenDriftSimulation
from .plot import _save_animation

logger = logging.getLogger(__name__)


class Lagrangian3DArray(LagrangianArray):
    """3D element with windage/current factors and terminal velocity
    (reference oceandrift.py:28-51)."""

    variables = LagrangianArray.add_variables([
        ("wind_drift_factor", {
            "dtype": np.float32, "units": "1", "default": 0.02,
            "description": "Elements at surface are moved with this "
            "fraction of the wind vector, in addition to currents and "
            "Stokes drift"}),
        ("current_drift_factor", {
            "dtype": np.float32, "units": "1", "default": 1.0,
            "description": "Elements are moved with this fraction of the "
            "current vector"}),
        ("terminal_velocity", {
            "dtype": np.float32, "units": "m/s", "default": 0.0,
            "description": "Terminal rise/sinking velocity (buoyancy) in "
            "the ocean column"}),
    ])


class OceanDrift(OpenDriftSimulation):
    """Generic 3-dimensional buoyant particle model
    (reference oceandrift.py:54)."""

    ElementType = Lagrangian3DArray

    required_variables = {
        "x_sea_water_velocity": {"fallback": 0},
        "y_sea_water_velocity": {"fallback": 0},
        "sea_surface_height": {"fallback": 0},
        "x_wind": {"fallback": 0},
        "y_wind": {"fallback": 0},
        "upward_sea_water_velocity": {
            "fallback": 0, "skip_if": ["drift:vertical_advection", "is", False]},
        "ocean_vertical_diffusivity": {
            "fallback": 0, "profiles": True,
            "profiles_if": ["vertical_mixing:diffusivitymodel", "is",
                            "environment"],
            "skip_if": ["drift:vertical_mixing", "is", False]},
        "horizontal_diffusivity": {"fallback": 0},
        "sea_surface_wave_significant_height": {"fallback": 0},
        "sea_surface_wave_stokes_drift_x_velocity": {
            "fallback": 0, "skip_if": ["drift:stokes_drift", "is", False]},
        "sea_surface_wave_stokes_drift_y_velocity": {
            "fallback": 0, "skip_if": ["drift:stokes_drift", "is", False]},
        "ocean_mixed_layer_thickness": {
            "fallback": 50, "skip_if": ["drift:vertical_mixing", "is", False]},
        "sea_floor_depth_below_sea_level": {"fallback": 10000},
        "land_binary_mask": {"fallback": None},
    }

    def add_config(self):
        self._add_config({
            "drift:vertical_advection": {
                "type": "bool", "default": True, "level": CONFIG_LEVEL_BASIC,
                "description": "Advect elements with vertical component of "
                "ocean current"},
            "drift:truncate_ocean_model_below_m": {
                "type": "float", "default": None, "min": 0, "max": 10000,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Ocean model data are only read down to at "
                "most this depth, and extrapolated below (reference "
                "oceandrift.py:170)"},
            "drift:vertical_advection_at_surface": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Allow vertical advection of elements at "
                "the very surface (z=0)"},
            "drift:vertical_advection_correction": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Subtract apparent vertical velocity from "
                "sea-level change"},
            "drift:water_column_stretching": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Adjust element depth when sea surface "
                "elevation changes"},
            "drift:vertical_mixing": {
                "type": "bool", "default": False, "level": CONFIG_LEVEL_BASIC,
                "description": "Activate vertical mixing scheme with inner "
                "loop"},
            "drift:vertical_mixing_at_surface": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Allow mixing of elements at the very "
                "surface (z=0)"},
            "vertical_mixing:timestep": {
                "type": "float", "default": 60.0, "min": 0.1, "max": 3600,
                "units": "seconds", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Inner time step of vertical mixing"},
            "vertical_mixing:diffusivitymodel": {
                "type": "enum", "default": "environment",
                "enum": ["environment", "stepfunction",
                         "windspeed_Sundby1983", "windspeed_Large1994",
                         "constant"],
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Algorithm/source for vertical diffusivity "
                "profile"},
            "vertical_mixing:background_diffusivity": {
                "type": "float", "default": 1.2e-5, "min": 0, "max": 1,
                "units": "m2s-1", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Background diffusivity below mixed layer"},
            "vertical_mixing:TSprofiles": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Update T and S (and with them the terminal "
                "velocity) from profiles in the mixing inner loop"},
            "vertical_mixing:use_pallas": {
                "type": "bool", "default": True,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Run the mixing inner loop through the "
                "fused mixing kernels (the name is the JAX package's); "
                "False takes the generic per-substep loop"},
            "drift:wind_drift_depth": {
                "type": "float", "default": 0.1, "min": 0, "max": 10,
                "units": "meters", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Windage decays linearly from the surface "
                "to zero at this depth"},
            "drift:stokes_drift": {
                "type": "bool", "default": True,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Advect elements with Stokes drift"},
            "drift:stokes_drift_profile": {
                "type": "enum", "default": "Phillips",
                "enum": ["monochromatic", "exponential", "Phillips",
                         "windsea_swell"],
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Stokes drift depth-decay profile"},
            "drift:use_tabularised_stokes_drift": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Estimate Stokes drift from wind via "
                "fetch-tabulated coefficients when not provided by "
                "readers"},
            "drift:tabularised_stokes_drift_fetch": {
                "type": "enum", "enum": ["5000", "25000", "50000"],
                "default": "25000", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Fetch length for tabulated Stokes drift"},
            "drift:relative_wind": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Use wind relative to ocean current for "
                "windage"},
            "drift:profile_depth": {
                "type": "float", "default": 50.0, "min": 0, "max": 1000,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Depth to which environment profiles are "
                "fetched"},
            "vertical_mixing:profile_levels": {
                "type": "int", "default": 26, "min": 2, "max": 201,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Number of fixed z-levels for environment "
                "profiles"},
            "seed:seafloor": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Seed elements at seafloor"},
        })

    def _profile_zlevels(self):
        depth = float(self.get_config("drift:profile_depth"))
        L = int(self.get_config("vertical_mixing:profile_levels"))
        return np.linspace(0.0, -depth, L, dtype=np.float32)

    def store_previous_env_vars(self):
        if self.get_config("drift:water_column_stretching") or \
                self.get_config("drift:vertical_advection_correction"):
            return ["sea_surface_height"]
        return []

    def water_column_stretching(self, ctx):
        """Adjust z for sea-level change (reference oceandrift.py:299-313)."""
        if not self.get_config("drift:water_column_stretching"):
            return
        d = ctx.state.data
        prev = d.get("prev_env_sea_surface_height")
        if prev is None:
            return
        delta = ctx.environment["sea_surface_height"] - prev
        delta = torch.where(torch.isfinite(delta), delta, 0.0)
        depth = torch.clamp_min(
            ctx.environment["sea_floor_depth_below_sea_level"], 0.1)
        ctx.set_var("z", d["z"] + delta * (d["z"] / depth))

    # ------------------------------------------------------------ update --
    def update(self, ctx):
        """One physics step (reference oceandrift.py:185-211)."""
        self.water_column_stretching(ctx)
        ctx.advect_ocean_current()
        ctx.advect_wind()
        ctx.stokes_drift()
        self.update_terminal_velocity(ctx)
        if self.get_config("drift:vertical_mixing"):
            self.vertical_mixing(ctx)
        else:
            self.vertical_buoyancy(ctx)
        self.vertical_advection(ctx)
        self.machine_learning_correction(ctx)

    # ------------------------------------------------- ML drift correction
    def set_ml_correction(self, weights, predictors, norm_in, norm_out,
                          output_scale=1.0 / 3600.0):
        """Attach a residual drift correction MLP (the JAX package's
        counterpart of the reference's optional Keras model,
        oceandrift.py:239-283).

        ``weights``: list of (W, b) arrays (tanh between layers);
        ``predictors``: environment variable names forming the input, in
        order; ``norm_in``/``norm_out``: (mean, std) arrays for input and
        output normalisation; the denormalised 2-component output is a
        residual displacement which ``output_scale`` converts to m/s
        (default: metres per hour to m/s), applied every step.
        """
        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32),
                                   device=self.device)
        self._ml = {
            "weights": [(dev(W), dev(b)) for W, b in weights],
            "predictors": list(predictors),
            "norm_in": (dev(norm_in[0]), dev(norm_in[1])),
            "norm_out": (dev(norm_out[0]), dev(norm_out[1])),
            "scale": float(output_scale),
        }
        new = [v for v in predictors if v not in self.required_variables]
        if new:
            # an instance copy: the class's table stays as it is
            self.required_variables = dict(self.required_variables)
            for v in new:
                self.required_variables[v] = {"fallback": 0.0}
            self.env.required_variables = self.required_variables
            # regenerate the environment:constant/fallback configs
            self._add_environment_configs()

    def machine_learning_correction(self, ctx):
        """Apply the attached MLP's residual correction (nothing unless
        :meth:`set_ml_correction` was called).  ``h @ W`` is a plain
        matrix product."""
        ml = getattr(self, "_ml", None)
        if ml is None:
            return
        mi, si = ml["norm_in"]
        mo, so = ml["norm_out"]
        x = torch.stack([ctx.environment[p] for p in ml["predictors"]],
                        dim=-1)
        h = (x - mi) / si
        n_layers = len(ml["weights"])
        for i, (W, b) in enumerate(ml["weights"]):
            h = torch.matmul(h, W) + b
            if i < n_layers - 1:
                h = torch.tanh(h)
        out = h * so + mo
        ctx.update_positions(out[:, 0] * ml["scale"],
                             out[:, 1] * ml["scale"])

    # ------------------------------------------------------ model hooks ---
    def update_terminal_velocity(self, ctx, Tprofiles=None, Sprofiles=None,
                                 zi=None):
        """Subclass hook: buoyancy from element/environment properties
        (reference oceandrift.py:285-291)."""

    def prepare_vertical_mixing(self, ctx):
        """Subclass hook (reference oceandrift.py:293)."""

    def mixing_carry_extra(self, ctx):
        """Extra per-element arrays carried through the mixing inner loop
        (e.g. droplet diameter for oil); written back afterwards."""
        return {}

    def terminal_velocity_inner(self, ctx, z, Tprof, Sprof, mix=None):
        """Terminal velocity inside the mixing inner loop at depth ``z``;
        the default is the element property (reference
        oceandrift.py:509-512)."""
        return ctx.state.data["terminal_velocity"]

    def surface_stick(self, ctx, mix):
        """Keep elements at/above the surface at z=0
        (reference oceandrift.py:374-378)."""
        mix["z"] = torch.clamp_max(mix["z"], 0.0)
        return mix

    def surface_wave_mixing(self, ctx, mix, dt_mix, key):
        """Subclass hook, e.g. oil wave entrainment
        (reference oceandrift.py:383-386)."""
        return mix

    def bottom_interaction(self, ctx, mix, zmin):
        """Subclass hook, e.g. sediment settling
        (reference oceandrift.py:380-381)."""
        return mix

    @staticmethod
    def profile_interp(ctx, prof, z):
        """Linear interpolation of an (L, N) profile at element depth
        ``z`` over the fixed ``ctx.zlevels`` (descending from 0)."""
        zlev = ctx.zlevels
        h = float(zlev[0] - zlev[1])
        L = zlev.shape[0]
        fi = torch.clip(-z / h, 0.0, L - 1.0)
        i0 = torch.clip(torch.floor(fi).to(torch.int64), 0, L - 2)
        w = fi - i0
        lo = torch.gather(prof, 0, i0[None, :])[0]
        hi = torch.gather(prof, 0, (i0 + 1)[None, :])[0]
        return lo * (1.0 - w) + hi * w

    def _mixing_fast_path(self, ctx, model, ntimes, dt_mix, zmin, moving,
                          extra, store_depths, has_TS_profiles):
        """Subclass hook: run the mixing inner loop through a fused kernel
        of its own and return True, or return False to leave it to the
        caller (e.g. OpenOil's wave-entrainment kernel,
        ops/mixing.visser_mixing_oil)."""
        return False

    def _mixing_kernels_applicable(self, model):
        """True when the inner loop can run through ``visser_mixing`` or
        ``visser_mixing_profile``: a windspeed or profile diffusivity
        model, every per-substep hook at its base implementation, and
        ``vertical_mixing:use_pallas`` on."""
        if model not in mixing.WINDSPEED_MODELS \
                and model not in ("environment", "constant"):
            return False
        cls = type(self)
        if not (cls.surface_stick is OceanDrift.surface_stick
                and cls.surface_wave_mixing is OceanDrift.surface_wave_mixing
                and cls.bottom_interaction is OceanDrift.bottom_interaction
                and cls.terminal_velocity_inner
                is OceanDrift.terminal_velocity_inner):
            return False
        return bool(self.get_config("vertical_mixing:use_pallas",
                                    default=True))

    # --------------------------------------------------- vertical physics -
    def vertical_advection(self, ctx):
        """(reference oceandrift.py:315-350)."""
        if not self.get_config("drift:vertical_advection"):
            return
        d = ctx.state.data
        w = ctx.environment["upward_sea_water_velocity"]
        if self.get_config("drift:vertical_advection_correction"):
            prev = d.get("prev_env_sea_surface_height")
            if prev is not None:
                ssh = ctx.environment["sea_surface_height"]
                delta = torch.where(torch.isfinite(prev), ssh - prev, 0.0)
                w_surface = delta / ctx.params["dt"]
                total = ssh + ctx.environment[
                    "sea_floor_depth_below_sea_level"]
                w = w - w_surface * (d["z"] + total) / torch.clamp_min(
                    total, 0.1)
        if self.get_config("drift:vertical_advection_at_surface"):
            applicable = d["z"] <= 0.0
        else:
            applicable = d["z"] < 0.0
        new_z = torch.clamp_max(d["z"] + d["moving"] * w * ctx.params["dt"],
                                0.0)
        ctx.set_var("z", torch.where(applicable, new_z, d["z"]))

    def vertical_buoyancy(self, ctx):
        """Buoyancy-only vertical motion (reference oceandrift.py:354-372)."""
        d = ctx.state.data
        new_z = torch.clamp_max(
            d["z"] + d["terminal_velocity"] * ctx.params["dt"], 0.0)
        z = torch.where(d["z"] < 0.0, new_z, d["z"])
        zmin = -(ctx.environment["sea_floor_depth_below_sea_level"]
                 + ctx.sea_surface_height())
        ctx.set_var("z", torch.maximum(z, zmin))

    def _diffusivity_at(self, ctx, z, Kprof, gradK, model):
        """Diffusivity and gradient at element depth: the nearest level of
        a profile (reference oceandrift.py:515-519), or a windspeed
        parameterisation on the reference's 1-metre nearest levels with a
        one-sided gradient at the surface (oceandrift.py:430-455)."""
        if Kprof is not None:
            h = float(ctx.zlevels[0] - ctx.zlevels[1])
            L = ctx.zlevels.shape[0]
            zi = torch.clip(torch.round(-z / h).to(torch.int64), 0,
                            L - 1)[None]
            return torch.gather(Kprof, 0, zi)[0], torch.gather(gradK, 0,
                                                               zi)[0]
        wind = ctx.wind_speed()
        mld = ctx.environment["ocean_mixed_layer_thickness"]
        bg = float(self.get_config("vertical_mixing:background_diffusivity"))

        def K_of(depth):
            return mixing._diffusivity(model, wind, mld, bg, depth)
        lvl = torch.minimum(torch.clamp_min(torch.round(torch.abs(z)), 0.0),
                            mld + 1.0)
        dKdz = torch.where(
            lvl == 0.0, K_of(lvl + 1.0) - K_of(lvl),
            (K_of(lvl + 1.0) - K_of(torch.clamp_min(lvl - 1.0, 0.0))) / 2.0)
        return K_of(lvl), dKdz

    def vertical_mixing(self, ctx, store_depths=False):
        """Visser (1997) random-walk mixing inner loop (reference
        oceandrift.py:397-571): through the mixing kernels where they
        apply, else a loop over the substeps."""
        d = ctx.state.data
        dt = ctx.params["dt"]
        dt_mix = float(self.get_config("vertical_mixing:timestep"))
        dt_mix = dt_mix * (1.0 if dt > 0 else -1.0)
        ntimes = max(1, abs(int(dt / dt_mix)))
        zmin = -(ctx.environment["sea_floor_depth_below_sea_level"]
                 + ctx.sea_surface_height())
        self.prepare_vertical_mixing(ctx)
        model = self.get_config("vertical_mixing:diffusivitymodel")
        Kprof = gradK = None
        if model == "environment":
            # the reference uses reader profiles only when a reader serves
            # the variable; with a fallback-only diffusivity it switches to
            # windspeed_Large1994 (reference oceandrift.py:432-445)
            if self.env.priority_list.get("ocean_vertical_diffusivity"):
                Kprof = ctx.profiles["ocean_vertical_diffusivity"]
            else:
                model = "windspeed_Large1994"
        if model == "constant":
            fb = float(self.env.fallback_values.get(
                "ocean_vertical_diffusivity", 0.0))
            Kprof = torch.full((ctx.zlevels.shape[0],) + tuple(d["z"].shape),
                               fb, dtype=torch.float32, device=d["z"].device)
        h = float(ctx.zlevels[0] - ctx.zlevels[1])
        if Kprof is not None:
            # -d(K)/d(level) like the reference's gradK (oceandrift.py
            # :503-505); levels descend, so the spacing is -h
            gradK = -torch.gradient(Kprof, dim=0)[0] / (-h)
            gradK = torch.where(torch.abs(gradK) < 1e-10, 0.0, gradK)
        mixing_at_surface = bool(
            self.get_config("drift:vertical_mixing_at_surface"))
        moving = d["moving"]
        # Key order as in the JAX package (bit-equal threefry, rng.py): the
        # subclass's prepare hook draws first, then this base key, then a
        # subclass's fast path.  The seed of the kernels and of the loop's
        # draws below is the base key's bits.
        base_key = ctx.next_key()
        Tprof = Sprof = None
        if self.get_config("vertical_mixing:TSprofiles") and ctx.profiles \
                and "sea_water_temperature" in ctx.profiles:
            Tprof = ctx.profiles["sea_water_temperature"]
            Sprof = ctx.profiles["sea_water_salinity"]
        extra = self.mixing_carry_extra(ctx)
        if self._mixing_fast_path(ctx, model, ntimes, dt_mix, zmin, moving,
                                  extra, store_depths, Tprof is not None):
            return
        seed = rng.bits(base_key)
        if not extra and not store_depths and Tprof is None \
                and self._mixing_kernels_applicable(model):
            w = d.get("terminal_velocity", torch.zeros_like(d["z"]))
            if Kprof is not None:       # 'environment' / 'constant' profiles
                z_out = mixing.visser_mixing_profile(
                    d["z"], moving, w, Kprof, gradK, zmin, seed,
                    elem=d["ID"], ntimes=ntimes, dt_mix=dt_mix, h=h,
                    mixing_at_surface=mixing_at_surface)
            else:
                z_out = mixing.visser_mixing(
                    d["z"], moving, w, ctx.wind_speed(),
                    ctx.environment.get("ocean_mixed_layer_thickness",
                                        torch.full_like(d["z"], 50.0)),
                    zmin, seed, elem=d["ID"], ntimes=ntimes, dt_mix=dt_mix,
                    model=model,
                    bg=float(self.get_config(
                        "vertical_mixing:background_diffusivity")),
                    mixing_at_surface=mixing_at_surface)
            ctx.set_var("z", torch.where(ctx.active, z_out, d["z"]))
            return
        # The generic loop: one pass of plain tensor operations a substep,
        # with the hooks a subclass may override.  Its walk draws are the
        # kernels' (SplitMix32 keyed by element ID, ops/mixing.py), so with
        # the base hooks it repeats the kernels' plain versions.
        elem_base = mixing._element_base(d["ID"], seed)
        adt = abs(dt_mix)
        mix = {"z": d["z"], "moving": moving, **extra}
        for i in range(ntimes):
            key = rng.fold_in(base_key, i)
            z = mix["z"]
            mv = mix["moving"]
            surface = z == 0.0
            w = self.terminal_velocity_inner(ctx, z, Tprof, Sprof, mix=mix)
            Kz, dKdz = self._diffusivity_at(ctx, z, Kprof, gradK, model)
            R = mixing._draw(elem_base, i)
            z = z - mv * (dKdz * dt_mix - R * torch.sqrt(Kz * adt * 6.0))
            z = torch.where(z >= 0.0, -z, z)               # surface reflect
            z = torch.where((z < zmin) & (mv == 1.0),
                            2.0 * zmin - z, z)             # seafloor reflect
            z = z + w * dt_mix * mv                        # buoyancy
            if not mixing_at_surface:
                z = torch.where(surface, 0.0, z)
            mix = dict(mix)
            mix["z"] = z
            mix = self.surface_stick(ctx, mix)
            mix = self.surface_wave_mixing(ctx, mix, adt, key)
            mix["z"] = torch.maximum(mix["z"], zmin)       # bottom stick
            mix = self.bottom_interaction(ctx, mix, zmin)
        active = ctx.active
        ctx.set_var("z", torch.where(active, mix["z"], d["z"]))
        ctx.set_var("moving", torch.where(active, mix["moving"], moving))
        for k in extra:
            ctx.set_var(k, torch.where(active, mix[k], d[k]))

    # ---------------------------------------------------- vertical plots --
    @staticmethod
    def get_diffusivity_profile(model, depths, wind_speed,
                                mixed_layer_depth=50.0,
                                background_diffusivity=0.0):
        """K(depth, wind) matrix for the windspeed parameterisations
        (reference oceandrift.py:385-396), in float32 on the host."""
        from ..ops import physics as ph
        wind, depth = np.meshgrid(np.atleast_1d(wind_speed),
                                  np.atleast_1d(depths))
        wind = torch.as_tensor(wind, dtype=torch.float32)
        depth = torch.as_tensor(depth, dtype=torch.float32)
        if model == "windspeed_Large1994":
            return ph.verticaldiffusivity_Large1994(
                wind, depth, mixed_layer_depth,
                background_diffusivity).numpy()
        if model == "windspeed_Sundby1983":
            return ph.verticaldiffusivity_Sundby1983(
                wind, depth, mixed_layer_depth,
                background_diffusivity).numpy()
        raise ValueError(f"unknown diffusivity model {model}")

    def plot_vertical_distribution(self, maxdepth=None, bins=50,
                                   time_index=-1, filename=None):
        """Histogram of element depths at one output time (reference
        oceandrift.py:650-712; the reference's interactive slider is the
        ``time_index`` argument here)."""
        plt = plotting.pyplot()
        z = np.asarray(self.result["z"])[:, time_index]
        z = z[np.isfinite(z)]
        if maxdepth is None:
            maxdepth = float(np.floor(z.min())) if z.size else -10.0
        fig, ax = plt.subplots(figsize=(5, 7))
        ax.hist(z, bins=bins, range=(maxdepth, 0),
                orientation="horizontal", color="steelblue")
        ax.set_ylim(maxdepth, 0)
        ax.set_xlabel("Number of elements")
        ax.set_ylabel("Depth [m]")
        if filename:
            fig.savefig(filename, dpi=100)
            plt.close(fig)
        else:
            return fig

    def animate_vertical_distribution(self, maxdepth=None, bins=50,
                                      subsamplingstep=1, filename=None):
        """Animated depth histogram over the output steps (reference
        oceandrift.py:573-648)."""
        plt = plotting.pyplot()
        manim = plotting.animation()
        zs = np.asarray(self.result["z"])
        n_time = zs.shape[1]
        if maxdepth is None:
            finite = zs[np.isfinite(zs)]
            maxdepth = float(np.floor(finite.min())) if finite.size \
                else -10.0
        fig, ax = plt.subplots(figsize=(5, 7))
        frames = range(0, n_time, max(1, int(subsamplingstep)))

        def draw(ti):
            ax.clear()
            z = zs[:, ti]
            z = z[np.isfinite(z)]
            ax.hist(z, bins=bins, range=(maxdepth, 0),
                    orientation="horizontal", color="steelblue")
            ax.set_ylim(maxdepth, 0)
            ax.set_xlabel("Number of elements")
            ax.set_ylabel("Depth [m]")
            ax.set_title(str(np.asarray(self.result.coords["time"])[ti]))

        anim = manim.FuncAnimation(fig, draw, frames=frames, interval=150)
        if filename:
            _save_animation(anim, filename, fps=6)
            plt.close(fig)
        else:
            return anim
