"""OpenOil: oil drift and weathering."""

from .openoil import OpenOil, Oil, OilType, get_oil_names

__all__ = ["OpenOil", "Oil", "OilType", "get_oil_names"]
