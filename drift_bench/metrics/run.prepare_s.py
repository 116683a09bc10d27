"""run.prepare_s: the seconds ``run()`` spends before its main loop
(``timers["preparing main loop"]`` of ``models/base.py``: the initial
state, the readers' subsets, the step's set-up), the mean per forecast."""


def read(record):
    values = [f["timers"]["preparing main loop"] for f in record.forecasts
              if "preparing main loop" in f["timers"]]
    return sum(values) / len(values) if values else None
