"""Typed, validated, namespaced configuration system.

Re-implements the behavioural contract of the reference's ``Configurable``
(reference: opendrift/config.py:11-211): every model owns a schema of
``namespace:key`` entries with type/min/max/enum/default/units/level
metadata; ``set_config`` validates values and suggests near-miss keys and
enum values; configs serialise to flat ``config_<key>`` attribute pairs for
round-tripping through output files.

The schema is plain host-side Python — nothing here touches the device.
Model step functions read resolved config values once at ``run()`` time.
This is the port's own copy of ``opendrift_tpu/config.py``: the port
imports nothing of the JAX package.
"""

import difflib
import numbers

CONFIG_LEVEL_ESSENTIAL = 1
CONFIG_LEVEL_BASIC = 2
CONFIG_LEVEL_ADVANCED = 3


class ConfigItem:
    __slots__ = ("type", "default", "min", "max", "enum", "units",
                 "description", "level", "value")

    def __init__(self, spec):
        self.type = spec.get("type", "str")
        self.default = spec.get("default", None)
        self.min = spec.get("min", None)
        self.max = spec.get("max", None)
        self.enum = spec.get("enum", None)
        self.units = spec.get("units", None)
        self.description = spec.get("description", "")
        self.level = spec.get("level", CONFIG_LEVEL_ADVANCED)
        self.value = self.default

    def spec_dict(self):
        return {
            "type": self.type, "default": self.default, "min": self.min,
            "max": self.max, "enum": self.enum, "units": self.units,
            "description": self.description, "level": self.level,
        }


class Configurable:
    """Mixin holding a validated config dict keyed by ``namespace:key``."""

    @property
    def _config(self):
        if not hasattr(self, "_config_items"):
            self._config_items = {}
        return self._config_items

    def _add_config(self, specs, overwrite=True):
        """Register config keys. ``specs`` maps key -> spec dict."""
        for key, spec in specs.items():
            if key in self._config and not overwrite:
                continue
            self._config[key] = ConfigItem(spec)

    def _config_hash_remove(self, key):
        self._config.pop(key, None)

    def get_configspec(self, prefix="", level=None):
        out = {}
        for key, item in self._config.items():
            if not key.startswith(prefix):
                continue
            if level is not None:
                levels = level if isinstance(level, (list, tuple)) else [level]
                if item.level not in levels:
                    continue
            out[key] = item.spec_dict()
        return out

    def list_configspec(self, prefix=""):
        """Readable listing of the config schema (reference
        config.py:34-53)."""
        for key, item in self._config.items():
            if not key.startswith(prefix):
                continue
            spec = item.spec_dict()
            t = spec.get("type")
            if t in ("float", "int"):
                rng = (f"min: {spec.get('min')}, max: {spec.get('max')} "
                       f"[{spec.get('units', '')}]")
            elif t == "enum":
                rng = str(spec.get("enum"))
            else:
                rng = ""
            desc = (spec.get("description") or "")[:40]
            print(f"{key:<45} [{item.value}] {t:<5} {rng} {desc}")

    def set_config(self, key, value):
        if key not in self._config:
            matches = difflib.get_close_matches(key, self._config.keys(), n=3)
            hint = f" Did you mean: {matches}?" if matches else ""
            raise ValueError(f"No config setting named '{key}'.{hint}")
        item = self._config[key]
        item.value = self._validate(key, item, value)
        return self

    def _set_config_default(self, key, value):
        """Change both default and current value (used by model ctors)."""
        item = self._config[key]
        item.default = value
        item.value = self._validate(key, item, value)

    def _validate(self, key, item, value):
        t = item.type
        if value is None:
            return None
        if t == "bool":
            if not isinstance(value, (bool,)) and value not in (0, 1):
                raise ValueError(f"Config '{key}' expects a boolean, got {value!r}")
            return bool(value)
        if t in ("float", "int"):
            if not isinstance(value, numbers.Number):
                raise ValueError(f"Config '{key}' expects a number, got {value!r}")
            if item.min is not None and value < item.min:
                raise ValueError(
                    f"Config '{key}' = {value} is below minimum {item.min}")
            if item.max is not None and value > item.max:
                raise ValueError(
                    f"Config '{key}' = {value} exceeds maximum {item.max}")
            return int(value) if t == "int" else float(value)
        if t == "enum":
            if value not in item.enum:
                matches = difflib.get_close_matches(
                    str(value), [str(e) for e in item.enum], n=3)
                hint = f" Did you mean: {matches}?" if matches else ""
                shown = list(item.enum)
                if len(shown) > 20:
                    shown = shown[:20] + [f"... ({len(item.enum)} options)"]
                raise ValueError(
                    f"Config '{key}': {value!r} not in {shown}.{hint}")
            return value
        return value

    def get_config(self, key, default="raise"):
        if key not in self._config:
            if default != "raise":
                return default
            matches = difflib.get_close_matches(key, self._config.keys(), n=3)
            hint = f" Did you mean: {matches}?" if matches else ""
            raise ValueError(f"No config setting named '{key}'.{hint}")
        return self._config[key].value

    def _config_to_attributes(self):
        """Flatten to ``{'config_<key>': value}`` for the result's attributes."""
        out = {}
        for key, item in self._config.items():
            v = item.value
            if v is None:
                v = "None"
            elif isinstance(v, bool):
                v = int(v)
            out[f"config_{key}"] = v
        return out

    def _config_from_attributes(self, attrs):
        """The inverse of :meth:`_config_to_attributes`: set each known
        key of ``{'config_<key>': value}`` (a result file's attributes)."""
        for key, value in attrs.items():
            if not key.startswith("config_"):
                continue
            ckey = key[len("config_"):]
            if ckey not in self._config:
                continue
            item = self._config[ckey]
            if isinstance(value, str) and value == "None":
                value = None
            elif item.type == "bool":
                value = bool(int(value))
            elif item.type == "int" and value is not None:
                value = int(value)
            elif item.type == "float" and value is not None:
                value = float(value)
            item.value = value
