"""ChemicalDrift: organic-chemical and metal transport and fate.

Port of ``opendrift_tpu/models/chemicaldrift.py`` (reference:
opendrift/models/chemicaldrift.py:34-3440): the 'organics' setup (five
species, dissolved LMM, DOC-associated, SPM-associated, sediment
reversible and buried, with KOW/KOC-derived partitioning rates: Park &
Clough 2014, Karickhoff & Morris 1985 kinetics, Arrhenius temperature and
Setchenow salinity corrections, pH corrections of dissociating organics)
and the Kd-based 'metals' setup; overall-rate-constant degradation in
water and sediment, two-film Henry-law volatilization, sinking of
SPM-bound chemical, sediment interaction and burial, all elementwise with
the speciation step of ``ops/speciation.py``.  Its ``bottom_interaction``
and ``terminal_velocity_inner`` override substep hooks, so the Visser walk
takes OceanDrift's generic per-substep loop and no mixing kernel.  The
diagnostics (density maps, budget, summary) and the emission seeding work
on the host, in numpy, as in the JAX package.
"""

import logging
import math
from datetime import datetime

import numpy as np
import torch

from .. import rng
from ..config import CONFIG_LEVEL_BASIC, CONFIG_LEVEL_ADVANCED, \
    CONFIG_LEVEL_ESSENTIAL
from ..ops.speciation import speciation_step
from ..ops import physics as ph
from ..utils.plotting import pyplot
from .oceandrift import OceanDrift, Lagrangian3DArray
from .radionuclides import on_device, resuspend

logger = logging.getLogger(__name__)

G = 9.81
R_GAS = 8.206e-5  # atm m3 / (mol K)


class Chemical(Lagrangian3DArray):
    """(reference chemicaldrift.py:34-70)."""

    variables = Lagrangian3DArray.add_variables([
        ("diameter", {"dtype": np.float32, "units": "m", "default": 0.0}),
        ("density", {"dtype": np.float32, "units": "kg/m^3",
                     "default": 2650.0,
                     "description": "Particle density (SPM-bound phase)"}),
        ("specie", {"dtype": np.int32, "units": "1", "default": 0}),
        ("mass", {"dtype": np.float32, "units": "ug", "default": 1e3}),
        ("mass_degraded", {"dtype": np.float32, "units": "ug",
                           "seed": False, "default": 0.0}),
        ("mass_degraded_water", {"dtype": np.float32, "units": "ug",
                                 "seed": False, "default": 0.0}),
        ("mass_degraded_sediment", {"dtype": np.float32, "units": "ug",
                                    "seed": False, "default": 0.0}),
        ("mass_volatilized", {"dtype": np.float32, "units": "ug",
                              "seed": False, "default": 0.0}),
    ])


SPECIES = ["LMM", "Humic colloid", "Particle reversible",
           "Sediment reversible", "Sediment slowly reversible"]
# metals partition without the humic phase but with a slowly-reversible
# particle pool (reference chemicaldrift.py:404-412 'metals' setup)
METAL_SPECIES = ["LMM", "Particle reversible", "Particle slowly reversible",
                 "Sediment reversible", "Sediment slowly reversible"]


def _compound_table():
    import json
    import os
    path = os.path.join(os.path.dirname(__file__),
                        "chemical_compounds.json")
    with open(path) as f:
        return json.load(f)


class ChemicalDrift(OceanDrift):
    """Organic chemical fate model (reference chemicaldrift.py:75)."""

    ElementType = Chemical

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
        "spm": {"fallback": 1.0},
        "ocean_mixed_layer_thickness": {"fallback": 50},
        "active_sediment_layer_thickness": {"fallback": 0.03},
        # pH drives KOC corrections of dissociating organics
        # (reference chemicaldrift.py:113-114)
        "sea_water_ph_reported_on_total_scale": {"fallback": 8.1},
        "pH_sediment": {"fallback": 6.9},
    }

    def add_config(self):
        super().add_config()
        self._add_config({
            # chemical identity (defaults: naphthalene, as the reference)
            "chemical:transformations:LogKOW": {
                "type": "float", "default": 3.361, "min": -3, "max": 10,
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "log octanol-water partition coefficient"},
            "chemical:transformations:TrefKOW": {
                "type": "float", "default": 25.0, "min": -3, "max": 30,
                "units": "C", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Reference temperature of KOW"},
            "chemical:transformations:DeltaH_KOC_Sed": {
                "type": "float", "default": -21036.0, "min": -1e6,
                "max": 1e6, "units": "J/mol",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sorption enthalpy, sediments"},
            "chemical:transformations:DeltaH_KOC_DOM": {
                "type": "float", "default": -25900.0, "min": -1e6,
                "max": 1e6, "units": "J/mol",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sorption enthalpy, DOM"},
            "chemical:transformations:Setchenow": {
                "type": "float", "default": 0.2503, "min": -10, "max": 10,
                "units": "L/mol", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Setchenow (salting-out) constant"},
            "chemical:transformations:KOC_DOM": {
                "type": "float", "default": -1.0, "min": -1, "max": 1e10,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "KOC to DOM (<0: estimate from KOW)"},
            "chemical:transformations:KOC_sed": {
                "type": "float", "default": -1.0, "min": -1, "max": 1e10,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "KOC to sediment (<0: estimate from KOW)"},
            "chemical:transformations:fOC_SPM": {
                "type": "float", "default": 0.05, "min": 0.01, "max": 0.1,
                "units": "gOC/g", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Organic-carbon fraction of SPM"},
            "chemical:transformations:fOC_sed": {
                "type": "float", "default": 0.05, "min": 0.01, "max": 0.1,
                "units": "gOC/g", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Organic-carbon fraction of sediment"},
            "chemical:transformations:slow_coeff": {
                "type": "float", "default": 0.0, "min": 0, "max": 1,
                "units": "1/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Slow-pool transfer coefficient"},
            "chemical:compound": {
                "type": "enum",
                "enum": [None] + sorted(_compound_table()),
                "default": None, "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Compound preset: applies the bundled "
                "partitioning/degradation/volatilization parameters "
                "(reference chemicaldrift.py:337-348, 3053+) via "
                "init_chemical_compound()"},
            "chemical:transfer_setup": {
                "type": "enum", "enum": ["organics", "metals"],
                "default": "organics", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Speciation scheme: KOW-based organics "
                "(Karickhoff kinetics) or Kd-based metals (Simonsen "
                "2019; reference chemicaldrift.py:404-433)"},
            "chemical:transformations:dissociation": {
                "type": "enum",
                "enum": ["nondiss", "acid", "base", "amphoter"],
                "default": "nondiss", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Dissociation state of the compound"},
            "chemical:transformations:pKa_acid": {
                "type": "float", "default": -1.0, "min": -1, "max": 14,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Acid dissociation constant"},
            "chemical:transformations:pKa_base": {
                "type": "float", "default": -1.0, "min": -1, "max": 14,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Base dissociation constant"},
            "chemical:transformations:Kd": {
                "type": "float", "default": 2.0, "min": 0, "max": 1e6,
                "units": "m3/kg", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Partition coefficient (metals setup)"},
            "chemical:transformations:Dc": {
                "type": "float", "default": 1.16e-5, "min": 0, "max": 1,
                "units": "1/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Desorption rate (metals setup)"},
            "chemical:transformations:S0": {
                "type": "float", "default": 0.0, "min": 0, "max": 100,
                "units": "PSU", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Salinity dependency of Kd (metals)"},
            "chemical:sediment:effective_fraction": {
                "type": "float", "default": 0.9, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Fraction of effective sediment sorbents"},
            "chemical:sediment:resuspension_critvel": {
                "type": "float", "default": 0.01, "min": 0, "max": 1,
                "units": "m/s", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Critical near-bottom speed for "
                "resuspension of sedimented chemical"},
            "chemical:sediment:resuspension_depth": {
                "type": "float", "default": 1.0, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Height above seabed of resuspended "
                "elements"},
            "chemical:sediment:resuspension_depth_uncert": {
                "type": "float", "default": 0.5, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Gaussian spread of resuspension height"},
            "chemical:transformations:Vpress": {
                "type": "float", "default": 11.2, "min": 0, "max": 1e6,
                "units": "Pa", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Vapour pressure"},
            "chemical:transformations:Tref_Vpress": {
                "type": "float", "default": 25.0, "min": -100, "max": 100,
                "units": "C", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Vapour-pressure reference temperature"},
            "chemical:transformations:DeltaH_Vpress": {
                "type": "float", "default": 55925.0, "min": -1e6,
                "max": 1e6, "units": "J/mol",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Vapour-pressure enthalpy"},
            "chemical:transformations:Solub": {
                "type": "float", "default": 31.4, "min": 0, "max": 1e6,
                "units": "g/m3", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Solubility"},
            "chemical:transformations:Tref_Solub": {
                "type": "float", "default": 25.0, "min": -100, "max": 100,
                "units": "C", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Solubility reference temperature"},
            "chemical:transformations:DeltaH_Solub": {
                "type": "float", "default": 25300.0, "min": -1e6,
                "max": 1e6, "units": "J/mol",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Solubility enthalpy"},
            "chemical:transformations:degradation": {
                "type": "bool", "default": True,
                "level": CONFIG_LEVEL_BASIC,
                "description": "Overall degradation"},
            "chemical:transformations:t12_W_tot": {
                "type": "float", "default": 224.08, "min": 1, "max": 1e7,
                "units": "hours", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Overall half-life in water"},
            "chemical:transformations:Tref_kWt": {
                "type": "float", "default": 25.0, "min": -3, "max": 30,
                "units": "C", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Reference T for water degradation"},
            "chemical:transformations:DeltaH_kWt": {
                "type": "float", "default": 50000.0, "min": -1e6,
                "max": 1e6, "units": "J/mol",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Activation enthalpy, water degradation"},
            "chemical:transformations:t12_S_tot": {
                "type": "float", "default": 5012.4, "min": 1, "max": 1e7,
                "units": "hours", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Overall half-life in sediment"},
            "chemical:transformations:Tref_kSt": {
                "type": "float", "default": 25.0, "min": -3, "max": 30,
                "units": "C", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Reference T for sediment degradation"},
            "chemical:transformations:DeltaH_kSt": {
                "type": "float", "default": 50000.0, "min": -1e6,
                "max": 1e6, "units": "J/mol",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Activation enthalpy, sediment degr."},
            "chemical:transformations:volatilization": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_BASIC,
                "description": "Henry-law volatilization"},
            "chemical:transformations:MolWt": {
                "type": "float", "default": 128.1705, "min": 1,
                "max": 10000, "units": "g/mol",
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Molecular weight"},
            "chemical:transformations:Henry": {
                "type": "float", "default": 4.551e-4, "min": 0, "max": 10,
                "units": "atm m3/mol", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Henry's law constant"},
            "chemical:sediment:mixing_depth": {
                "type": "float", "default": 0.03, "min": 0, "max": 10,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment mixing depth"},
            "chemical:sediment:density": {
                "type": "float", "default": 2600.0, "min": 0, "max": 10000,
                "units": "kg/m3", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment particle density"},
            "chemical:sediment:corr_factor": {
                "type": "float", "default": 0.1, "min": 0, "max": 10,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment correction factor"},
            "chemical:sediment:porosity": {
                "type": "float", "default": 0.6, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment porosity"},
            "chemical:sediment:layer_thickness": {
                "type": "float", "default": 1.0, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Seabed interaction layer thickness"},
            "chemical:sediment:desorption_depth": {
                "type": "float", "default": 1.0, "min": 0, "max": 100,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Height above seabed after desorption"},
            "chemical:sediment:burial_rate": {
                "type": "float", "default": 0.00003, "min": 0, "max": 10,
                "units": "m/year", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Sediment burial rate"},
            "chemical:particle_diameter": {
                "type": "float", "default": 5e-6, "min": 0, "max": 1e-3,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "SPM diameter"},
            "chemical:dissolved_diameter": {
                "type": "float", "default": 0.0, "min": 0, "max": 1e-3,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Diameter of dissolved species"},
            "chemical:particle_diameter_uncertainty": {
                "type": "float", "default": 1e-7, "min": 0, "max": 1e-3,
                "units": "m", "level": CONFIG_LEVEL_ADVANCED,
                "description": "Gaussian std added to particle diameter"},
            "seed:LMM_fraction": {
                "type": "float", "default": 0.1, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Fraction seeded dissolved (reference "
                "default 0.1, chemicaldrift.py:156)"},
            "seed:particle_fraction": {
                "type": "float", "default": 0.9, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Fraction seeded SPM-bound (reference "
                "default 0.9, chemicaldrift.py:159)"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._set_config_default("drift:vertical_mixing", True)
        self._set_config_default("drift:vertical_mixing_at_surface",
                                 True)  # reference :352
        self._set_config_default("drift:vertical_advection_at_surface",
                                 True)  # reference chemicaldrift.py:353
        self.register_status("sedimented")

    @property
    def name_species(self):
        setup = self.get_config("chemical:transfer_setup",
                                default="organics")
        return METAL_SPECIES if setup == "metals" else SPECIES

    @property
    def nspecies(self):
        return len(self.name_species)

    def specie_name2num(self, name):
        return self.name_species.index(name)

    def init_chemical_compound(self, chemical_compound=None):
        """Apply the bundled per-compound parameter presets (PAH
        partitioning/degradation/volatilization constants and metal Kd
        values; reference chemicaldrift.py:3053+, data collected by
        Hanstein/Boscherini/Calgaro/Aghito)."""
        if chemical_compound is not None:
            self.set_config("chemical:compound", chemical_compound)
        compound = self.get_config("chemical:compound")
        if compound is None:
            raise ValueError("Chemical compound not defined")
        table = _compound_table()
        if compound not in table:
            raise ValueError(f"No parameters for compound {compound!r}; "
                             f"known: {sorted(table)}")
        for key, value in table[compound].items():
            self.set_config(key, value)

    # --------------------------------------------------- rate derivation --
    @staticmethod
    def tempcorr(DH, T, Tref):
        """Arrhenius temperature correction
        (reference chemicaldrift.py:560-575), on tensors and on Python
        floats alike."""
        R = 8.314
        x = -(DH / R) * (1.0 / (T + 273.15) - 1.0 / (Tref + 273.15))
        return torch.exp(x) if torch.is_tensor(x) else math.exp(x)

    @staticmethod
    def salinitycorr(setchenow, T, S):
        """Setchenow salting-out correction: Kd_fin = 10^(Ks * [salt])
        with [salt] = (S / MWsalt) * rho_sw(T,S) mol/L (reference
        chemicaldrift.py:567-590, Schwarzenbach et al.)."""
        MWsalt = 68.35
        dens = ph.sea_water_density(T, S) * 1e-3       # kg/L
        return 10.0 ** (setchenow * (S / MWsalt) * dens)

    # ---- pH-dependent KOC corrections for dissociating organics ----
    # (ePiE Technical Manual 2019 estimates for the dissociated forms;
    # formulas follow the reference verbatim, including its use of the
    # acid-form KOC in 'base' mode and the pH-independent base term of
    # the amphoteric neutral fraction)

    @staticmethod
    def _koc_diss_forms(KOW, pKa_acid):
        """(reference chemicaldrift.py:597-598)."""
        koc_acid = 10.0 ** (0.11 * math.log10(KOW) + 1.54)
        koc_base = 10.0 ** (pKa_acid ** (0.65 * ((KOW / (KOW + 1.0))
                                                 ** 0.14)))
        return koc_acid, koc_base

    @classmethod
    def calc_KOC_corr_particle(cls, KOC_initial, KOC_n, pKa_acid,
                               pKa_base, KOW, pH, diss):
        """KOC correction factor for sediment / SPM sorbed phases
        (reference calc_KOC_sedcorr / calc_KOC_watcorrSPM,
        chemicaldrift.py:593-672), vectorised over per-element pH."""
        koc_acid, koc_base = cls._koc_diss_forms(KOW, pKa_acid)
        if diss == "acid":
            phi_n = 1.0 / (1.0 + 10.0 ** (pH - pKa_acid))
            upd = KOC_n * phi_n + (1.0 - phi_n) * koc_acid
        elif diss == "base":
            phi_n = 1.0 / (1.0 + 10.0 ** (pH - pKa_base))
            upd = KOC_n * phi_n + (1.0 - phi_n) * koc_acid
        elif diss == "amphoter":
            phi_n = 1.0 / (1.0 + 10.0 ** (pH - pKa_acid)
                           + 10.0 ** pKa_base)
            anion = phi_n * 10.0 ** (pH - pKa_acid)
            cation = phi_n * 10.0 ** (pKa_base - pH)
            upd = KOC_n * phi_n + anion * koc_acid + cation * koc_base
        else:   # 'undiss'
            return torch.ones_like(pH)
        return upd / KOC_initial

    @staticmethod
    def calc_KOC_corr_DOM(KOC_initial, KOC_n, pKa_acid, pKa_base, KOW,
                          pH, diss):
        """KOC correction factor for the DOM-bound phase
        (reference calc_KOC_watcorrDOM, chemicaldrift.py:674-713)."""
        if diss == "acid":
            phi_n = 1.0 / (1.0 + 10.0 ** (pH - pKa_acid))
        elif diss == "base":
            phi_n = 1.0 / (1.0 + 10.0 ** (pH - pKa_base))
        elif diss == "amphoter":
            phi_n = 1.0 / (1.0 + 10.0 ** (pH - pKa_acid)
                           + 10.0 ** pKa_base)
        else:   # 'undiss'
            return torch.ones_like(pH)
        upd = (0.08 * (phi_n * KOC_n
                       + phi_n * 10.0 ** (math.log10(KOW) - 3.5))) / 0.526
        return upd / KOC_initial

    def transfer_rates_matrix(self):
        """Background speciation rates: 'organics' (Karickhoff & Morris
        1985 KOW kinetics) or 'metals' (Kd/Dc, Simonsen et al. 2019) —
        reference chemicaldrift.py init_transfer_rates :404-433."""
        if self.get_config("chemical:transfer_setup") == "metals":
            return self._metal_transfer_rates()
        S = self.nspecies
        rates = np.zeros((S, S), dtype=np.float32)
        lmm = self.specie_name2num("LMM")
        hum = self.specie_name2num("Humic colloid")
        prev = self.specie_name2num("Particle reversible")
        srev = self.specie_name2num("Sediment reversible")
        ssrev = self.specie_name2num("Sediment slowly reversible")

        Org2C = 0.526
        KOW = 10.0 ** self.get_config("chemical:transformations:LogKOW")
        fOC_SPM = self.get_config("chemical:transformations:fOC_SPM")
        fOC_sed = self.get_config("chemical:transformations:fOC_sed")
        KOC_DOM = self.get_config("chemical:transformations:KOC_DOM")
        if KOC_DOM < 0:
            KOC_DOM = 2.88 * KOW ** 0.67      # Park & Clough (2014)
        KOC_sed = self.get_config("chemical:transformations:KOC_sed")
        if KOC_sed < 0:
            KOC_sed = 2.62 * KOW ** 0.82      # Park & Clough (2014)
        KOC_SPM = KOC_sed

        self.Kd_sed = KOC_sed * fOC_sed
        self.Kd_SPM = KOC_SPM * fOC_SPM
        self.Kd_DOM = KOC_DOM * Org2C

        k_ads = 33.3 / 3600.0                 # Karickhoff & Morris (1985)
        k_des_sed = k_ads / self.Kd_sed
        k_des_SPM = k_ads / self.Kd_SPM
        k_des_DOM = k_ads / self.Kd_DOM

        concDOM = 1.0e-3 / Org2C * 1e-3       # kg/L
        concSPM = 50.0e-3 * 1e-3              # kg/L
        sed_L = self.get_config("chemical:sediment:mixing_depth")
        sed_dens = self.get_config("chemical:sediment:density")
        sed_phi = self.get_config("chemical:sediment:corr_factor")
        sed_poro = self.get_config("chemical:sediment:porosity")
        sed_H = self.get_config("chemical:sediment:layer_thickness")
        burial = self.get_config("chemical:sediment:burial_rate")

        # desorption entries at reference conditions; per-element T/S
        # corrections are applied in update_speciation (reference
        # update_transfer_rates, chemicaldrift.py:1204-1260)
        rates[lmm, hum] = k_ads * concDOM
        rates[hum, lmm] = k_des_DOM
        rates[lmm, prev] = k_ads * concSPM
        rates[prev, lmm] = k_des_SPM
        rates[lmm, srev] = k_ads * sed_L * sed_dens * (1 - sed_poro) \
            * sed_phi / sed_H * 1e-3
        rates[srev, lmm] = k_des_sed * sed_phi
        rates[srev, ssrev] = burial / sed_L / 31556926.0
        return rates

    def _metal_transfer_rates(self):
        """Kd-based metal speciation rates (Simonsen et al. 2019a;
        reference chemicaldrift.py 'metals' branch :404-412 and rate
        assignments in init_transfer_rates)."""
        S = self.nspecies
        rates = np.zeros((S, S), dtype=np.float32)
        lmm = self.specie_name2num("LMM")
        prev = self.specie_name2num("Particle reversible")
        psrev = self.specie_name2num("Particle slowly reversible")
        srev = self.specie_name2num("Sediment reversible")
        ssrev = self.specie_name2num("Sediment slowly reversible")

        Kd = self.get_config("chemical:transformations:Kd")       # m3/kg
        Dc = self.get_config("chemical:transformations:Dc")       # 1/s
        slow = self.get_config("chemical:transformations:slow_coeff")
        concSPM = 1.0e-3                                          # kg/m3
        sed_L = self.get_config("chemical:sediment:mixing_depth")
        sed_dens = self.get_config("chemical:sediment:density")
        sed_f = self.get_config("chemical:sediment:effective_fraction")
        sed_phi = self.get_config("chemical:sediment:corr_factor")
        sed_poro = self.get_config("chemical:sediment:porosity")
        sed_H = self.get_config("chemical:sediment:layer_thickness")

        rates[lmm, prev] = Dc * Kd * concSPM
        rates[prev, lmm] = Dc
        rates[lmm, srev] = Dc * Kd * sed_L * sed_dens \
            * (1.0 - sed_poro) * sed_f * sed_phi / sed_H
        rates[srev, lmm] = Dc * sed_phi
        rates[srev, ssrev] = slow
        rates[prev, psrev] = slow
        rates[ssrev, srev] = slow * 0.1
        rates[psrev, prev] = slow * 0.1
        return rates

    # --------------------------------------------------------- seeding ----
    def seed_elements(self, *args, **kwargs):
        number = kwargs.get("number")
        if number is None:
            number = int(self.get_config("seed:number"))
        if "specie" not in kwargs:
            lmm_f = self.get_config("seed:LMM_fraction")
            n_lmm = int(round(number * lmm_f))
            specie = np.full(number, self.specie_name2num(
                "Particle reversible"), dtype=np.int32)
            specie[:n_lmm] = self.specie_name2num("LMM")
            kwargs["specie"] = specie
        if "diameter" not in kwargs:
            # particle-bound elements start at the configured SPM
            # diameter (+ uncertainty); dissolved at 0
            # (reference seed_elements, chemicaldrift.py:540-549)
            specie = np.atleast_1d(np.asarray(kwargs["specie"]))
            dia = np.zeros(max(specie.size, number), dtype=np.float32)
            is_p = np.broadcast_to(specie, dia.shape) \
                == self.specie_name2num("Particle reversible")
            std = self.get_config("chemical:particle_diameter_uncertainty")
            dia[is_p] = self.get_config("chemical:particle_diameter") \
                + np.random.normal(0, std, int(is_p.sum()))
            kwargs["diameter"] = dia
        return super().seed_elements(*args, **kwargs)

    # ---------------------------------------------------------- physics ---
    def _is_sediment(self, specie):
        srev = self.specie_name2num("Sediment reversible")
        ssrev = self.specie_name2num("Sediment slowly reversible")
        return (specie == srev) | (specie == ssrev)

    def update_terminal_velocity(self, ctx, **kwargs):
        d = ctx.state.data
        T0 = ctx.environment["sea_water_temperature"]
        S0 = ctx.environment["sea_water_salinity"]
        rho_w = ph.sea_water_density(T0, S0)
        mu_w = ph.sea_water_dynamic_viscosity(T0, S0)
        # per-element particle density and diameter (reference
        # chemicaldrift.py:1156,1187; diameter is seeded per element
        # and updated on species change)
        dia = d["diameter"]
        w = -(d["density"] - rho_w) * G * dia ** 2 / (18.0 * mu_w)
        on_spm = d["specie"] == self.specie_name2num("Particle reversible")
        ctx.set_var("terminal_velocity", torch.where(on_spm, w, 0.0))

    def terminal_velocity_inner(self, ctx, z, Tprof, Sprof,
                                mix=None):
        return ctx.state.data["terminal_velocity"]

    def update_speciation(self, ctx):
        """(reference chemicaldrift.py:1530-1650)."""
        d = ctx.state.data
        rates, = on_device(self, d["z"].device,
                           np.asarray(self.transfer_rates_matrix()))
        row = rates[d["specie"].long()]                 # (N, S), a copy
        lmm = self.specie_name2num("LMM")
        srev = self.specie_name2num("Sediment reversible")
        prev = self.specie_name2num("Particle reversible")
        thick = self.get_config("chemical:sediment:layer_thickness")
        dist = d["z"] + ctx.environment["sea_floor_depth_below_sea_level"]
        far = (d["specie"] == lmm) & (dist > thick)
        row[:, srev] = torch.where(far, 0.0, row[:, srev])
        # adsorption to SPM scaled by local concentration: the organics
        # base rate is built at 50 g/m3, the metals base rate at 1 g/m3
        # (reference: concSPM = spm*1e-3 kg/m3, update_transfer_rates
        # :1368 and metals branch :1397)
        is_metals = self.get_config("chemical:transfer_setup") == "metals"
        spm = ctx.environment["spm"]
        is_lmm = d["specie"] == lmm
        spm_scale = spm / (1.0 if is_metals else 50.0)
        row[:, prev] = torch.where(is_lmm, row[:, prev] * spm_scale,
                                   row[:, prev])
        if is_metals:
            # Kd salinity adjustment, Perianez 2018 (reference :1393-1396)
            S0 = self.get_config("chemical:transformations:S0")
            if S0 > 0:
                Sal = ctx.environment["sea_water_salinity"]
                kd_corr = (S0 + Sal) / S0
                for col in (prev, srev):
                    row[:, col] = torch.where(is_lmm, row[:, col] * kd_corr,
                                              row[:, col])

        # per-element T/S correction of the organics desorption rates
        # (inversely proportional to Kd; reference update_transfer_rates
        # chemicaldrift.py:1204-1260), with pH-dependent KOC corrections
        # for dissociating chemicals (reference :1246-1340)
        if self.get_config("chemical:transfer_setup") == "organics":
            T = ctx.environment["sea_water_temperature"]
            Sal = ctx.environment["sea_water_salinity"]
            Tref = self.get_config("chemical:transformations:TrefKOW")
            DH_sed = self.get_config(
                "chemical:transformations:DeltaH_KOC_Sed")
            DH_dom = self.get_config(
                "chemical:transformations:DeltaH_KOC_DOM")
            setch = self.get_config("chemical:transformations:Setchenow")
            sc = self.salinitycorr(setch, T, Sal)
            hum = self.specie_name2num("Humic colloid")
            is_dom = d["specie"] == hum
            is_spm = d["specie"] == prev
            is_sed = d["specie"] == srev
            corr = torch.where(
                is_dom, self.tempcorr(DH_dom, T, Tref) * sc,
                torch.where(is_spm | is_sed,
                            self.tempcorr(DH_sed, T, Tref) * sc, 1.0))
            diss = self.get_config("chemical:transformations:dissociation")
            if diss != "nondiss":
                # transfer_rates_matrix above has set self.Kd_* and the
                # neutral-form KOCs; corrections are ratios vs those
                pKa_acid = self.get_config(
                    "chemical:transformations:pKa_acid")
                pKa_base = self.get_config(
                    "chemical:transformations:pKa_base")
                if diss in ("acid", "amphoter") and pKa_acid < 0:
                    raise ValueError("pKa_acid must be positive")
                if diss in ("base", "amphoter") and pKa_base < 0:
                    raise ValueError("pKa_base must be positive")
                KOW = 10.0 ** self.get_config(
                    "chemical:transformations:LogKOW")
                fOC_SPM = self.get_config(
                    "chemical:transformations:fOC_SPM")
                fOC_sed = self.get_config(
                    "chemical:transformations:fOC_sed")
                KOC_sed_n = self.Kd_sed / fOC_sed
                KOC_DOM_n = self.Kd_DOM / 0.526
                pH_w = ctx.environment[
                    "sea_water_ph_reported_on_total_scale"]
                pH_s = ctx.environment["pH_sediment"]
                corr_sed = self.calc_KOC_corr_particle(
                    KOC_sed_n, KOC_sed_n, pKa_acid, pKa_base, KOW,
                    pH_s, diss)
                corr_spm = self.calc_KOC_corr_particle(
                    self.Kd_SPM / fOC_SPM, KOC_sed_n, pKa_acid,
                    pKa_base, KOW, pH_w, diss)
                corr_dom = self.calc_KOC_corr_DOM(
                    KOC_DOM_n, KOC_DOM_n, pKa_acid, pKa_base, KOW,
                    pH_w, diss)
                koc = torch.where(is_dom, corr_dom,
                                  torch.where(is_spm, corr_spm,
                                              torch.where(is_sed, corr_sed,
                                                          1.0)))
                corr = corr / torch.clamp_min(koc, 1e-30)
            row[:, lmm] = row[:, lmm] / torch.clamp_min(corr, 1e-12)

        new_specie, transformed = speciation_step(
            d["specie"], row, ctx.params["dt"], ctx.next_key(), ctx.active)

        to_sed = transformed & self._is_sediment(new_specie) \
            & ~self._is_sediment(d["specie"])
        depth = ctx.environment["sea_floor_depth_below_sea_level"]
        z = torch.where(to_sed, -depth, d["z"])
        moving = torch.where(to_sed, 0.0, d["moving"])
        from_sed = transformed & self._is_sediment(d["specie"]) \
            & ~self._is_sediment(new_specie)
        lift = self.get_config("chemical:sediment:desorption_depth")
        z = torch.where(from_sed, -depth + lift, z)
        moving = torch.where(from_sed, 1.0, moving)
        ctx.set_var("specie", new_specie, mask=ctx.active)
        ctx.set_var("z", torch.clamp_max(z, 0.0))
        ctx.set_var("moving", moving)
        self.update_chemical_diameter(ctx, d["specie"], new_specie)

    def update_chemical_diameter(self, ctx, sp_in, sp_out):
        """Reset element diameter when the species changes: particle
        species get chemical:particle_diameter (+ gaussian uncertainty;
        halved for SPM aggregated from humic colloids), dissolved and
        colloid species get chemical:dissolved_diameter
        (reference update_chemical_diameter, chemicaldrift.py:1550-1620).
        The noise's key is taken only when the uncertainty is above 0."""
        d = ctx.state.data
        dia_part = self.get_config("chemical:particle_diameter")
        dia_diss = self.get_config("chemical:dissolved_diameter")
        std = self.get_config("chemical:particle_diameter_uncertainty")

        def num(name):
            try:
                return self.specie_name2num(name)
            except ValueError:
                return None

        changed = sp_out != sp_in
        diameter = d["diameter"]
        noise = std * rng.normal(ctx.next_key(), tuple(diameter.shape),
                                 diameter.device) if std > 0 else 0.0
        hum = num("Humic colloid")
        for name in ("Particle reversible", "Particle slowly reversible",
                     "Particle irreversible"):
            sp = num(name)
            if sp is None:
                continue
            to_part = changed & (sp_out == sp)
            base = dia_part
            if name == "Particle reversible" and hum is not None:
                # aggregated from humic colloids: half diameter
                base = torch.where(sp_in == hum, dia_part / 2.0, dia_part)
            diameter = torch.where(to_part, base + noise, diameter)
        for name in ("LMM", "LMManion", "LMMcation", "Colloid",
                     "Humic colloid"):
            sp = num(name)
            if sp is None:
                continue
            diameter = torch.where(changed & (sp_out == sp), dia_diss,
                                   diameter)
        ctx.set_var("diameter", diameter)

    def degradation(self, ctx):
        """Overall rate-constant degradation
        (reference chemicaldrift.py:1685-1745)."""
        if not self.get_config("chemical:transformations:degradation"):
            return
        d = ctx.state.data
        dt = abs(ctx.params["dt"])
        T = ctx.environment["sea_water_temperature"]
        in_sed = self._is_sediment(d["specie"])
        k_W = math.log(2) / (self.get_config(
            "chemical:transformations:t12_W_tot") * 3600.0)
        k_S = math.log(2) / (self.get_config(
            "chemical:transformations:t12_S_tot") * 3600.0)
        k_W = k_W * self.tempcorr(
            self.get_config("chemical:transformations:DeltaH_kWt"), T,
            self.get_config("chemical:transformations:Tref_kWt"))
        k_S = k_S * self.tempcorr(
            self.get_config("chemical:transformations:DeltaH_kSt"), T,
            self.get_config("chemical:transformations:Tref_kSt"))
        # the water rate applies ONLY to dissolved + DOM-bound species;
        # SPM-bound elements do not degrade at all in the reference
        # (W mask = lmm + humcol, chemicaldrift.py:1702-1711; S mask =
        # srev + ssrev, :1719-1728)
        lmm = self.specie_name2num("LMM")
        in_water = d["specie"] == lmm
        try:
            hum = self.specie_name2num("Humic colloid")
            in_water = in_water | (d["specie"] == hum)
        except (KeyError, ValueError):
            pass
        k = torch.where(in_sed, k_S, torch.where(in_water, k_W, 0.0))
        frac = torch.where(ctx.active, 1.0 - torch.exp(-k * dt), 0.0)
        lost = d["mass"] * frac
        ctx.set_var("mass", d["mass"] - lost)
        ctx.set_var("mass_degraded", d["mass_degraded"] + lost)
        ctx.set_var("mass_degraded_water",
                    d["mass_degraded_water"]
                    + torch.where(in_sed, 0.0, lost))
        ctx.set_var("mass_degraded_sediment",
                    d["mass_degraded_sediment"]
                    + torch.where(in_sed, lost, 0.0))

    def volatilization(self, ctx):
        """Two-film Henry-law volatilization of dissolved chemical in the
        mixed layer (reference chemicaldrift.py:1748-1860)."""
        if not self.get_config("chemical:transformations:volatilization"):
            return
        d = ctx.state.data
        dt = abs(ctx.params["dt"])
        T = ctx.environment["sea_water_temperature"]
        mld = ctx.environment["ocean_mixed_layer_thickness"]
        wind = ctx.wind_speed()
        S = ctx.environment["sea_water_salinity"]
        molwt = self.get_config("chemical:transformations:MolWt")
        # Henry's constant from vapour pressure / solubility with
        # Arrhenius temperature corrections (reference
        # chemicaldrift.py:1789-1792)
        Vp = self.get_config("chemical:transformations:Vpress")
        Slb = self.get_config("chemical:transformations:Solub")
        henry = (Vp * self.tempcorr(
            self.get_config("chemical:transformations:DeltaH_Vpress"),
            T, self.get_config("chemical:transformations:Tref_Vpress"))) \
            / (Slb * self.tempcorr(
                self.get_config("chemical:transformations:DeltaH_Solub"),
                T, self.get_config("chemical:transformations:Tref_Solub"))) \
            * molwt / 101325.0                        # atm m3/mol
        # salting-out + dimensionless Henry (reference :1815)
        R_atm = 8.206e-5                              # atm m3/(mol K)
        Hnd = henry * (1.0 + 0.01143 * S) / (R_atm * (T + 273.15))
        # two-film mass-transfer coefficients, Schwarzenbach et al. 2016
        # Eq. 19-17..19-20 (reference :1797-1812), cm/s
        MTCw = (9e-4 + 7.2e-6 * wind ** 3) * (44.0 / molwt) ** 0.25
        Sca = 0.62
        MTCaH2O = 0.1 + wind * (6.1 + 0.63 * wind) ** 0.5 \
            / (13.3 * Sca ** 0.5 + (6.1e-4 + 6.3e-5 * wind) ** -0.5
               - 5.0 + 1.25 * math.log(Sca))
        MTCa = MTCaH2O * (18.0 / molwt) ** (1.0 / 3.0)
        MTCvol = 1.0 / (1.0 / MTCw + 1.0 / (MTCa * Hnd))   # cm/s
        k_vol = 0.01 * MTCvol                              # m/s
        lmm = self.specie_name2num("LMM")
        applies = ctx.active & (d["specie"] == lmm) & (-d["z"] <= mld)
        frac = torch.where(applies,
                           1.0 - torch.exp(-k_vol * dt
                                           / torch.clamp_min(mld, 1.0)),
                           0.0)
        lost = d["mass"] * frac
        ctx.set_var("mass", d["mass"] - lost)
        ctx.set_var("mass_volatilized", d["mass_volatilized"] + lost)

    def bottom_interaction(self, ctx, mix, zmin):
        d = ctx.state.data
        on_spm = d["specie"] == self.specie_name2num("Particle reversible")
        at_bottom = (mix["z"] <= zmin) & on_spm
        mix["moving"] = torch.where(at_bottom, 0.0, mix["moving"])
        return mix

    def resuspension(self, ctx):
        """Resuspend sedimented chemical where the near-bottom current
        exceeds the critical speed: Sediment reversible -> Particle
        reversible, lifted resuspension_depth above the seabed
        (reference chemicaldrift.py:1633-1680)."""
        resuspend(ctx, self.specie_name2num("Sediment reversible"),
                  self.specie_name2num("Particle reversible"),
                  self.get_config("chemical:sediment:resuspension_critvel"),
                  self.get_config("chemical:sediment:resuspension_depth"),
                  self.get_config(
                      "chemical:sediment:resuspension_depth_uncert"))

    def update(self, ctx):
        """(reference chemicaldrift.py:1862-1910)."""
        self.update_speciation(ctx)
        self.resuspension(ctx)
        self.degradation(ctx)
        self.volatilization(ctx)
        ctx.advect_ocean_current()
        self.update_terminal_velocity(ctx)
        if self.get_config("drift:vertical_mixing"):
            self.vertical_mixing(ctx)
        else:
            self.vertical_buoyancy(ctx)
        self.vertical_advection(ctx)

    def specie_num2name(self, num):
        return self.name_species[num]

    # -------------------------------------------------------- diagnostics -
    def get_chemical_density_array(self, pixelsize_m, zlevels,
                                   weight="mass", origin_marker=None):
        """Per-specie, per-depth-layer mass histogram on a lon/lat grid
        (reference chemicaldrift.py:2530-2670 ``get_chemical_density_
        array``).  ``zlevels``: negative depths ascending towards zero,
        e.g. [-50, -10, -5]; layer k spans [zlevels[k], next boundary),
        the top layer ends at 0 and the deepest layer also collects
        anything below it.  Returns (H, lon_bins, lat_bins, boundaries)
        with H dims (time, specie, layer, lon, lat) holding summed
        ``weight``."""
        ds = self.result
        lon = ds["lon"].values
        lat = ds["lat"].values
        z = ds["z"].values
        specie = ds["specie"].values
        w = ds[weight].values if weight else np.ones_like(lon)
        if origin_marker is not None and "origin_marker" in ds:
            om = ds["origin_marker"].values
            w = np.where(om == origin_marker, w, 0.0)
        lonbin, latbin = self.get_lonlat_bins(pixelsize_m)
        bounds = sorted([float(v) for v in zlevels]) + [0.0]
        L = len(bounds) - 1
        n_time = lon.shape[1]
        S = self.nspecies
        H = np.zeros((n_time, S, L, len(lonbin) - 1, len(latbin) - 1),
                     dtype=np.float32)
        for ti in range(n_time):
            ok = np.isfinite(lon[:, ti]) & np.isfinite(w[:, ti])
            zi = np.clip(np.searchsorted(bounds, z[:, ti],
                                         side="right") - 1, 0, L - 1)
            for si in range(S):
                sel0 = ok & (specie[:, ti] == si)
                for li in range(L):
                    sel = sel0 & (zi == li)
                    if not sel.any():
                        continue
                    h, _, _ = np.histogram2d(
                        lon[sel, ti], lat[sel, ti],
                        bins=[lonbin, latbin], weights=w[sel, ti])
                    H[ti, si, li] = h
        return H, lonbin, latbin, np.asarray(bounds)

    def get_pixel_mean_depth(self, lons, lats):
        """Bathymetry sampled at concentration-grid pixel centres from
        the reader serving sea_floor_depth_below_sea_level (reference
        ``get_pixel_mean_depth``, chemicaldrift.py:2685-2716).  Returns
        positive depths (m); falls back to the configured fallback value
        when no gridded bathymetry is available."""
        var = "sea_floor_depth_below_sea_level"
        lons = np.asarray(lons, np.float64)
        try:
            vals = self.env.get_variables_along_trajectory(
                [var], lons, np.asarray(lats, np.float64),
                [self.start_time] * lons.size)[var]
            vals = np.asarray(vals, np.float64)
            vals[~np.isfinite(vals)] = 0.0
            return vals
        except Exception as e:
            logger.debug("pixel mean depth unavailable (%s); using "
                         "fallback depth", e)
            fb = self.required_variables[var].get("fallback", 100)
            return np.full(lons.size, float(fb))

    @staticmethod
    def horizontal_smooth(H, cells=1):
        """Box smoothing over the two trailing (lon, lat) axes
        (reference chemicaldrift.py ``horizontal_smooth``)."""
        from scipy.ndimage import uniform_filter
        size = [1] * (H.ndim - 2) + [2 * cells + 1, 2 * cells + 1]
        return uniform_filter(H, size=size, mode="constant")

    def write_netcdf_chemical_density_map(
            self, filename, pixelsize_m=1000.0, zlevels=(-5.0,),
            mass_unit="ug", horizontal_smoothing=False,
            smoothing_cells=1, time_avg_conc=False, origin_marker=None):
        """Gridded chemical concentration map, per specie and depth
        layer (reference chemicaldrift.py:1944 / :1957-2520
        ``write_netcdf_chemical_density_map``): mass histograms divided
        by the cell volume (pixel area x layer thickness) -> mass_unit/L,
        written as CF NetCDF."""
        from scipy.io import netcdf_file
        H, lonbin, latbin, bounds = self.get_chemical_density_array(
            pixelsize_m, zlevels, weight="mass",
            origin_marker=origin_marker)
        if horizontal_smoothing:
            H = self.horizontal_smooth(H, smoothing_cells)
        lat_c = 0.5 * (latbin[:-1] + latbin[1:])
        lon_c = 0.5 * (lonbin[:-1] + lonbin[1:])
        # per-pixel cell volume: layer thickness truncated by the local
        # bathymetry (pixel mean depth), zeroed below 0.1 m and NaN'd
        # where dry — concentrations in shallow pixels divide by the
        # real water volume (reference chemicaldrift.py:2238-2254)
        area = float(pixelsize_m) ** 2                # m2
        lon_g, lat_g = np.meshgrid(lon_c, lat_c, indexing="ij")
        depth = self.get_pixel_mean_depth(
            lon_g.ravel(), lat_g.ravel()).reshape(lon_g.shape)
        L = len(bounds) - 1
        vol_L = np.zeros((L,) + lon_g.shape)
        for zi in range(L):
            floor = np.maximum(-depth, bounds[zi])
            tt = bounds[zi + 1] - floor
            tt[tt < 0.1] = 0.0
            vol_L[zi] = tt * area * 1000.0            # litres
        vol_L[vol_L == 0.0] = np.nan
        scale = {"ug": 1.0, "mg": 1e-3, "g": 1e-6, "kg": 1e-9}[mass_unit]
        conc = H * scale / vol_L[None, None, :, :, :]
        times = self.result.coords["time"].astype("datetime64[s]")
        secs = (times - np.datetime64("1970-01-01T00:00:00", "s")
                ).astype("float64")
        f = netcdf_file(filename, "w", version=2)
        try:
            f.createDimension("time", conc.shape[0])
            f.createDimension("specie", conc.shape[1])
            f.createDimension("depth", conc.shape[2])
            f.createDimension("lon", len(lon_c))
            f.createDimension("lat", len(lat_c))
            v = f.createVariable("time", "d", ("time",))
            v[:] = secs
            v.units = "seconds since 1970-01-01 00:00:00"
            v = f.createVariable("depth", "f", ("depth",))
            v[:] = -np.asarray(bounds[:-1], np.float32)  # layer start
            v.units = "m"
            v = f.createVariable("lon", "d", ("lon",))
            v[:] = lon_c
            v.units = "degrees_east"
            v = f.createVariable("lat", "d", ("lat",))
            v[:] = lat_c
            v.units = "degrees_north"
            v = f.createVariable("concentration", "f",
                                 ("time", "specie", "depth", "lon",
                                  "lat"))
            v[:] = conc.astype(np.float32)
            v.units = f"{mass_unit}/L"
            v.long_name = (str(self.get_config("chemical:compound"))
                           + " concentration; species "
                           + ", ".join(self.name_species))
            if time_avg_conc:
                v = f.createVariable("concentration_avg", "f",
                                     ("specie", "depth", "lon", "lat"))
                v[:] = conc.mean(axis=0).astype(np.float32)
                v.units = f"{mass_unit}/L"
            f.flush()
        finally:
            f.close()

    def simulation_summary(self, chemical_compound=None):
        """Print final speciation and mass balance
        (reference chemicaldrift.py:1913-1950)."""
        ds = self.result
        specie = ds["specie"].values[:, -1]
        print(chemical_compound
              or self.get_config("chemical:compound"))
        print("Final speciation:")
        for i, name in enumerate(self.name_species):
            print(f"{name:32}: {int((specie == i).sum()):>6}")
        m_pre = np.nansum(ds["mass"].values[:, -1])
        m_deg = np.nansum(ds["mass_degraded"].values[:, -1])
        m_vol = np.nansum(ds["mass_volatilized"].values[:, -1])
        m_tot = m_pre + m_deg + m_vol
        if m_tot > 0:
            print("Mass balance:")
            print(f"mass preserved   : {m_pre * 1e-6:.3g} g "
                  f"{100 * m_pre / m_tot:.1f}%")
            print(f"mass degraded    : {m_deg * 1e-6:.3g} g "
                  f"{100 * m_deg / m_tot:.1f}%")
            print(f"mass volatilized : {m_vol * 1e-6:.3g} g "
                  f"{100 * m_vol / m_tot:.1f}%")

    def plot_mass(self, filename=None):
        """Stacked time series of the chemical mass budget (reference
        chemicaldrift.py ``plot_mass``).  The result's times are a numpy
        array; the JAX package's ``.values`` of them raises (ROADMAP
        C.9)."""
        plt = pyplot()
        budget = self.get_chemical_budget()
        times = np.asarray(self.result.coords["time"])
        fig, ax = plt.subplots()
        ax.stackplot(times, budget["mass_total_active"],
                     budget["mass_degraded"],
                     budget["mass_volatilized"],
                     labels=["active", "degraded", "volatilized"])
        ax.set_ylabel("mass [ug]")
        ax.legend(loc="upper left")
        if filename:
            fig.savefig(filename, dpi=100)
            plt.close(fig)
        else:
            return fig

    def get_chemical_budget(self):
        ds = self.result
        mass = np.nan_to_num(ds["mass"].values, nan=0.0)
        out = {
            "mass_total_active": mass.sum(axis=0),
            "mass_degraded": np.nan_to_num(
                ds["mass_degraded"].values, nan=0.0).sum(axis=0),
            "mass_volatilized": np.nan_to_num(
                ds["mass_volatilized"].values, nan=0.0).sum(axis=0),
        }
        return out


def datetime64_to_datetime(t):
    """A ``numpy.datetime64`` as a naive ``datetime``, to the microsecond
    (what ``pandas.Timestamp(t).to_pydatetime()`` gives; the card machine
    has no pandas)."""
    return np.datetime64(t, "us").astype(datetime)


def _emission_factor_table():
    import json
    import os
    path = os.path.join(os.path.dirname(__file__),
                        "chemical_emission_factors.json")
    with open(path) as f:
        return json.load(f)


def _append_emission_seeding():
    """Scrubber-water / ship-emission seeding helpers (reference
    chemicaldrift.py:2754-3050, data from Hermansson et al. 2021 /
    EMERGE D2.1/D3.2)."""

    def emission_factors(self, scrubber_type, chemical_compound):
        """Emission factor [ug per unit of the discharge variable] for a
        compound in a given discharge stream (reference :2754-2986)."""
        t = _emission_factor_table()
        direct = {"open_loop", "closed_loop", "bilge_water",
                  "grey_water", "sewage_water"}
        if scrubber_type in direct:
            return t[scrubber_type][chemical_compound][0]
        if scrubber_type == "AFP":
            return 1e6 * t["AFP"][chemical_compound][0]     # g -> ug
        if scrubber_type == "AFP_metals_total":
            return 1e6
        if scrubber_type in ("N_sewage", "N_foodwaste",
                             "SILAM_metals"):
            return 1e9                                       # kg -> ug
        if scrubber_type == "SILAM_metals_from_ash":
            return 1e9 * t["SILAM_ash"][chemical_compound][0]
        raise ValueError(f"unknown scrubber_type {scrubber_type!r}")

    def seed_from_DataArray(self, data, longitude=None, latitude=None,
                            time=None, lowerbound=0, higherbound=np.inf,
                            radius=0, scrubber_type="open_loop",
                            chemical_compound="Copper",
                            mass_element_ug=100e3,
                            number_of_elements=None, **kwargs):
        """Seed chemical mass from a gridded discharge/deposition field
        (reference chemicaldrift.py:2988-3049 ``seed_from_STEAM``).

        ``data``: 3D array (time, latitude, longitude) of discharge
        volume per cell — or an xarray-like object with
        ``.data``/``.time``/``.latitude``/``.longitude`` attributes, in
        which case the coordinate arguments may be omitted."""
        if longitude is None and hasattr(data, "longitude"):
            longitude = np.asarray(data.longitude)
            latitude = np.asarray(data.latitude)
            time = np.asarray(data.time)
            data = np.asarray(data.data)
        data = np.asarray(data)
        if chemical_compound is None:
            chemical_compound = self.get_config("chemical:compound")
        factor = self.emission_factors(scrubber_type, chemical_compound)
        sel = np.where((data > lowerbound) & (data < higherbound))
        if number_of_elements is not None:
            total_mass = data[sel].sum() * factor
            mass_element_ug = total_mass / number_of_elements
        for ti, yi, xi in zip(*sel):
            mass_ug = data[ti, yi, xi] * factor
            number = max(int(mass_ug / mass_element_ug), 1)
            t = time[ti]
            if not hasattr(t, "year"):      # numpy datetime64
                t = datetime64_to_datetime(t)
            self.seed_elements(
                lon=float(longitude[xi]), lat=float(latitude[yi]),
                time=t, number=number, radius=radius,
                mass=mass_ug / number, **kwargs)

    ChemicalDrift.emission_factors = emission_factors
    ChemicalDrift.seed_from_DataArray = seed_from_DataArray
    ChemicalDrift.seed_from_STEAM = seed_from_DataArray


_append_emission_seeding()
