"""run.initial_state_s: the seconds ``run()`` spends building the initial
state of the elements (``timers["preparing main loop:initial state"]`` of
``models/base.py``: the host arrays of every element and the move of the
seeds to the nearest ocean cell), the mean per forecast."""

KEY = "preparing main loop:initial state"


def read(record):
    values = [f["timers"][KEY] for f in record.forecasts
              if KEY in f["timers"]]
    return sum(values) / len(values) if values else None
