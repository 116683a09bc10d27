"""Graphical launcher for drift simulations (Tkinter).

The port's copy of ``opendrift_tpu/scripts/gui.py``, the counterpart of the
reference's Tkinter GUI (reference: opendrift/scripts/opendrift_gui.py:
1-977): model picker, seeding form, config entries generated from the
model's config schema, forcing-file list, run button with live log, and
post-run plot/animation.  The simulation logic lives in
:class:`GuiController` (testable headless), whose models run on its
``device`` (``cuda`` unless ``device="cpu"``); :class:`OpenDriftGUI` is the
thin Tk view.

    python -m opendrift_tpu_torch.scripts.gui [--device cuda|cpu]
"""

import argparse
import logging
import sys
from datetime import datetime, timedelta

logger = logging.getLogger(__name__)

GUI_MODELS = ["OceanDrift", "OpenOil", "Leeway", "ShipDrift", "OpenBerg",
              "PlastDrift", "RadionuclideDrift", "ChemicalDrift",
              "SedimentDrift", "PelagicEggDrift"]


class GuiController:
    """Headless application logic behind the GUI."""

    def __init__(self, device=None):
        from ..interop import resolve_device
        self.device = resolve_device(device)
        self.model_name = GUI_MODELS[0]
        self.simulation = None
        self.reader_paths = []

    # ------------------------------------------------------------- model
    def available_models(self):
        from .. import get_model_names
        names = get_model_names()
        return [m for m in GUI_MODELS if m in names]

    def select_model(self, name):
        from .. import get_model
        self.model_name = name
        self.simulation = get_model(name)(loglevel=logging.INFO,
                                          device=self.device)
        return self.simulation

    def seed_config_items(self):
        """(key, spec) config entries relevant for seeding forms
        (reference opendrift_gui.py builds forms from config levels)."""
        if self.simulation is None:
            self.select_model(self.model_name)
        out = []
        for key in self.simulation._config:
            if key.startswith("seed:"):
                out.append((key, self.simulation._config[key]))
        return out

    def config_form_groups(self, max_level=2):
        """Config entries grouped by namespace for the generated forms,
        like the reference GUI's per-level tabs (reference
        opendrift_gui.py: forms built from CONFIG_LEVEL_ESSENTIAL/
        BASIC entries of the selected model).  Returns an ordered
        {group: [(key, spec_dict), ...]} with spec dicts carrying
        type/default/min/max/units/enum/description."""
        if self.simulation is None:
            self.select_model(self.model_name)
        groups = {}
        for key, spec in self.simulation._config.items():
            level = getattr(spec, "level", 3)
            if level is None or level > max_level:
                continue
            group = key.split(":")[0]
            groups.setdefault(group, []).append((key, {
                "type": getattr(spec, "type", "float"),
                "default": getattr(spec, "default", None),
                "min": getattr(spec, "min", None),
                "max": getattr(spec, "max", None),
                "units": getattr(spec, "units", None),
                "enum": getattr(spec, "enum", None),
                "description": getattr(spec, "description", ""),
            }))
        return groups

    def parse_config_value(self, key, text):
        """Parse a form string into the config's native type; raises
        ValueError with the config description on bad input."""
        spec = self.simulation._config[key]
        typ = getattr(spec, "type", "float")
        text = text.strip() if isinstance(text, str) else text
        if text in ("", "None", None):
            return None
        if typ in ("float", "int"):
            val = float(text)
            if typ == "int":
                val = int(val)
            return val
        if typ == "bool":
            if isinstance(text, bool):
                return text
            return str(text).lower() in ("1", "true", "yes", "on")
        return text                     # enum / str: validated by set_config

    def apply_config_form(self, values, log=print):
        """Apply {key: string} form values through set_config (typed,
        validated, difflib suggestions on typos)."""
        if self.simulation is None:
            self.select_model(self.model_name)
        applied = 0
        for key, text in values.items():
            val = self.parse_config_value(key, text)
            current = self.simulation.get_config(key)
            if val is None or val == current:
                continue
            self.simulation.set_config(key, val)
            log(f"set_config {key} = {val!r}")
            applied += 1
        return applied

    def add_forcing(self, path):
        from ..fields.factory import reader_from_url
        reader = reader_from_url(path)
        self.simulation.add_reader(reader)
        self.reader_paths.append(path)
        return reader

    # --------------------------------------------------------------- run
    def run(self, lon, lat, radius=0.0, number=1000, start_time=None,
            duration_hours=12.0, time_step=900, outfile=None,
            seed_kwargs=None, end_lon=None, end_lat=None, end_time=None,
            log=print):
        """Seed + run; returns the simulation object.  Giving
        end_lon/end_lat (and optionally end_time) seeds a cone between
        the two positions like the reference GUI's start/end form."""
        if self.simulation is None:
            self.select_model(self.model_name)
        o = self.simulation
        start_time = start_time or datetime.utcnow()
        log(f"Seeding {number} {self.model_name} elements at "
            f"({lon:.3f}, {lat:.3f})")
        for reader in getattr(o.env, "readers", {}).values():
            try:
                import numpy as _np
                if not _np.any(reader.covers_positions(
                        _np.atleast_1d(lon), _np.atleast_1d(lat))):
                    log(f"WARNING: seed position is outside reader "
                        f"'{reader.name}' — elements may not move")
            except Exception:
                pass
        if end_lon is not None and end_lat is not None:
            times = [start_time, end_time] if end_time else start_time
            o.seed_cone(lon=[float(lon), float(end_lon)],
                        lat=[float(lat), float(end_lat)],
                        radius=float(radius), number=int(number),
                        time=times, **(seed_kwargs or {}))
        else:
            o.seed_elements(lon=float(lon), lat=float(lat),
                            radius=float(radius), number=int(number),
                            time=start_time, **(seed_kwargs or {}))
        log(f"Running {duration_hours} h, dt={time_step} s")
        o.run(duration=timedelta(hours=float(duration_hours)),
              time_step=int(time_step), outfile=outfile)
        log("Simulation finished.")
        return o


class OpenDriftGUI:
    """Tk view (requires a display)."""

    def __init__(self, device=None):
        import tkinter as tk
        from tkinter import ttk, filedialog, scrolledtext
        self.tk = tk
        self.ttk = ttk
        self.filedialog = filedialog
        self.ctl = GuiController(device=device)

        self.root = tk.Tk()
        self.root.title("opendrift_tpu_torch")
        row = 0

        tk.Label(self.root, text="Model:").grid(row=row, column=0,
                                                sticky="w")
        self.model_var = tk.StringVar(value=self.ctl.model_name)
        names = self.ctl.available_models()
        ttk.Combobox(self.root, textvariable=self.model_var,
                     values=names, state="readonly"
                     ).grid(row=row, column=1, sticky="we")
        row += 1

        self.entries = {}
        for label, default in [("Longitude", "4.5"), ("Latitude", "60.0"),
                               ("End longitude (cone)", ""),
                               ("End latitude (cone)", ""),
                               ("Radius [m]", "1000"),
                               ("Number", "1000"),
                               ("Start (YYYY-mm-dd HH:MM)",
                                datetime.utcnow().strftime(
                                    "%Y-%m-%d %H:%M")),
                               ("End (YYYY-mm-dd HH:MM, cone)", ""),
                               ("Duration [h]", "12"),
                               ("Time step [s]", "900")]:
            tk.Label(self.root, text=label).grid(row=row, column=0,
                                                 sticky="w")
            e = tk.Entry(self.root)
            e.insert(0, default)
            e.grid(row=row, column=1, sticky="we")
            self.entries[label] = e
            row += 1

        tk.Button(self.root, text="Add forcing file...",
                  command=self._add_forcing).grid(row=row, column=0)
        tk.Button(self.root, text="Run", command=self._run
                  ).grid(row=row, column=1)
        row += 1
        tk.Button(self.root, text="Model config...",
                  command=self._config_form).grid(row=row, column=0)
        row += 1
        tk.Button(self.root, text="Plot", command=self._plot
                  ).grid(row=row, column=0)
        tk.Button(self.root, text="Animate", command=self._animate
                  ).grid(row=row, column=1)
        row += 1

        self.log_box = scrolledtext.ScrolledText(self.root, height=14,
                                                 width=72)
        self.log_box.grid(row=row, column=0, columnspan=2)

    def _log(self, msg):
        self.log_box.insert(self.tk.END, str(msg) + "\n")
        self.log_box.see(self.tk.END)
        self.root.update_idletasks()

    def _add_forcing(self):
        path = self.filedialog.askopenfilename()
        if path:
            self.ctl.select_model(self.model_var.get())
            r = self.ctl.add_forcing(path)
            self._log(f"Added reader: {r.name}")

    def _config_form(self):
        """Generated per-model config form: one labelled frame per
        config namespace, widget type from the schema (enum -> combobox,
        bool -> checkbutton, numbers -> entry with units/range hint) —
        the reference GUI's auto-generated forms from config levels
        (reference opendrift_gui.py)."""
        tk, ttk = self.tk, self.ttk
        self.ctl.select_model(self.model_var.get())
        top = tk.Toplevel(self.root)
        top.title(f"{self.model_var.get()} configuration")
        canvas = tk.Canvas(top, width=560, height=620)
        scroll = ttk.Scrollbar(top, orient="vertical",
                               command=canvas.yview)
        frame = ttk.Frame(canvas)
        frame.bind("<Configure>", lambda e: canvas.configure(
            scrollregion=canvas.bbox("all")))
        canvas.create_window((0, 0), window=frame, anchor="nw")
        canvas.configure(yscrollcommand=scroll.set)
        canvas.pack(side="left", fill="both", expand=True)
        scroll.pack(side="right", fill="y")

        widgets = {}
        for group, items in self.ctl.config_form_groups().items():
            box = ttk.LabelFrame(frame, text=group)
            box.pack(fill="x", padx=4, pady=3)
            for r, (key, spec) in enumerate(items):
                label = key.split(":", 1)[-1]
                if spec["units"]:
                    label += f" [{spec['units']}]"
                ttk.Label(box, text=label).grid(row=r, column=0,
                                                sticky="w")
                current = self.ctl.simulation.get_config(key)
                if spec["enum"]:
                    var = tk.StringVar(value=str(current))
                    ttk.Combobox(box, textvariable=var, state="readonly",
                                 values=[str(v) for v in spec["enum"]]
                                 ).grid(row=r, column=1, sticky="we")
                elif spec["type"] == "bool":
                    var = tk.BooleanVar(value=bool(current))
                    ttk.Checkbutton(box, variable=var).grid(
                        row=r, column=1, sticky="w")
                else:
                    var = tk.StringVar(value="" if current is None
                                       else str(current))
                    e = ttk.Entry(box, textvariable=var)
                    e.grid(row=r, column=1, sticky="we")
                    if spec["min"] is not None:
                        ttk.Label(box, text=f"{spec['min']}.."
                                  f"{spec['max']}").grid(
                            row=r, column=2, sticky="w")
                widgets[key] = var

        def apply():
            try:
                n = self.ctl.apply_config_form(
                    {k: v.get() for k, v in widgets.items()},
                    log=self._log)
                self._log(f"Applied {n} config change(s)")
                top.destroy()
            except Exception as exc:
                self._log(f"ERROR: {exc}")

        ttk.Button(frame, text="Apply", command=apply).pack(pady=4)

    def _run(self):
        e = self.entries
        try:
            self.ctl.model_name = self.model_var.get()
            start = datetime.strptime(
                e["Start (YYYY-mm-dd HH:MM)"].get(), "%Y-%m-%d %H:%M")
            end_lon = e["End longitude (cone)"].get().strip() or None
            end_lat = e["End latitude (cone)"].get().strip() or None
            end_s = e["End (YYYY-mm-dd HH:MM, cone)"].get().strip()
            end_time = datetime.strptime(end_s, "%Y-%m-%d %H:%M") \
                if end_s else None
            self.ctl.run(
                lon=float(e["Longitude"].get()),
                lat=float(e["Latitude"].get()),
                radius=float(e["Radius [m]"].get()),
                number=int(e["Number"].get()),
                start_time=start,
                end_lon=float(end_lon) if end_lon else None,
                end_lat=float(end_lat) if end_lat else None,
                end_time=end_time,
                duration_hours=float(e["Duration [h]"].get()),
                time_step=int(e["Time step [s]"].get()),
                log=self._log)
        except Exception as exc:  # surface errors in the log box
            self._log(f"ERROR: {exc}")

    def _plot(self):
        if self.ctl.simulation is not None:
            self.ctl.simulation.plot()

    def _animate(self):
        if self.ctl.simulation is not None:
            self.ctl.simulation.animation()

    def mainloop(self):
        self.root.mainloop()


def main(argv=None):
    p = argparse.ArgumentParser(description="Graphical launcher for drift "
                                "simulations (needs a display)")
    p.add_argument("--device", default="cuda",
                   help="Device the simulations run on (default cuda)")
    args = p.parse_args(argv)
    try:
        gui = OpenDriftGUI(device=args.device)
    except Exception as e:
        print(f"Cannot start GUI ({e}); a display is required.",
              file=sys.stderr)
        sys.exit(1)
    gui.mainloop()


if __name__ == "__main__":
    main()
