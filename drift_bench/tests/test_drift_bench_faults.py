"""A run with its timed path broken underneath comes out not correct: the
harness's look for a card skipped, a tiny cell on the CPU, each fault a
forecast of this configuration can have (one chip: no exchange between
chips to leave out), and faults that touch few of the compared pairs: the
last output frame alone, and the coast's stranding switched off."""

import pytest
import torch

from drift_bench import run
from drift_bench.tests.tiny import tiny_cell
from opendrift_tpu_torch.models.base import OpenDriftSimulation, StepContext


def _unchanged(real):
    def make(self, K, dt):
        advance, final = real(self, K, dt)

        def stuck(state, dev_states, t0_rel, key):
            _, snap = advance(state, dev_states, t0_rel, key)
            return state, snap
        return stuck, final
    return make


def _half(real):
    def make(self, K, dt):
        advance, final = real(self, K, dt)

        def half(state, dev_states, t0_rel, key):
            new, snap = advance(state, dev_states, t0_rel, key)
            n = new.data["lon"].shape[0] // 2
            keep = {k: torch.cat([v[:n], state.data[k][n:]])
                    for k, v in new.data.items()
                    if k in ("lon", "lat", "z")}
            return new.replace(**keep), snap
        return half, final
    return make


FAULTS = {
    "state_unchanged": (OpenDriftSimulation, "_make_advance", _unchanged),
    "half_the_elements": (OpenDriftSimulation, "_make_advance", _half),
}


def _altered(real):
    def commit(self, u, v):
        real(self, u, v)
        d = self.state.data
        self.state = self.state.replace(lat=d["lat"] + 1e-4)
    return commit


FAULTS["answer_altered"] = (StepContext, "_commit_positions", _altered)


def _last_frame_stale(real):
    """The last output frame repeats the one before it."""
    def assemble(self, frames, frame_times, trim=True):
        return real(self, frames[:-1] + frames[-2:-1], frame_times, trim)
    return assemble


def _never_strands(real):
    """The coast's action read as 'none': nothing strands."""
    def get_config(self, key, *args, **kw):
        if key == "general:coastline_action":
            return "none"
        return real(self, key, *args, **kw)
    return get_config


# a day's forecast: the last frame is one of 24, the stranded elements a
# few in a hundred of the pairs
FEW_PAIRS = {
    "last_frame_stale": (OpenDriftSimulation, "_assemble_result",
                         _last_frame_stale),
    "never_strands": (OpenDriftSimulation, "get_config", _never_strands),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_run_is_not_correct(fault, monkeypatch):
    owner, name, wrap = FAULTS[fault]
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    cell = tiny_cell(elements=1000, hours=4, sample=400)
    code, result, rows = run.execute(cell, 31, 0.0, False, "cpu")
    assert code == 0
    assert result["correct"] is False, rows


@pytest.mark.parametrize("fault", sorted(FEW_PAIRS))
def test_a_fault_in_few_pairs_is_not_correct(fault, monkeypatch):
    owner, name, wrap = FEW_PAIRS[fault]
    monkeypatch.setattr(owner, name, wrap(getattr(owner, name)))
    cell = tiny_cell(elements=2000, hours=24, sample=600)
    code, result, rows = run.execute(cell, 47, 0.0, False, "cpu")
    assert code == 0
    assert result["sample"]["stranded_pct"] > 1.0
    assert result["correct"] is False, rows
