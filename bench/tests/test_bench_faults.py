"""A whole run on the CPU at ``reduced()`` sizes (the look for a card
skipped), with the served step broken underneath: ``correct`` must come
out false for each fault a serving cell can have, and true without one.

The faults: a step that returns its state unchanged (no cache write, the
position not advanced); half of the batch left out (its tokens those of
the other half); a token altered where it is produced (one step's logits
shifted by one vocabulary entry).  One chip, so there is no exchange
between chips to leave out.  Every finished request is judged here.

Readings at these sizes over seeds 1-5 (the widest gap in logits): sound
runs 0-3.5e-3; the faults 0.084-1.30.  The limit of 2e-2 lies between.
"""

import time
import types

import pytest

from _bench_small import small_cell
from harness import runner

LIMIT = 2e-2
WORKLOADS = ["granite_20b-8L.plain-b64-c2k", "yi_6b.plain-b64-c2k"]


class Faulty:
    """A serving entry whose step is broken as ``fault`` says."""

    def __init__(self, inner, fault):
        self.inner, self.fault, self.calls = inner, fault, 0

    def counters(self):
        return self.inner.counters()

    def instrument(self, span):
        return self.inner.instrument(span)

    def step(self, state, tokens):
        self.calls += 1
        logits, new_state = self.inner.step(state, tokens)
        if self.fault == "state_unchanged":
            return logits, state
        if self.fault == "half_batch":
            h = logits.shape[0] // 2
            logits = logits.clone()
            logits[h:] = logits[:h]
        if self.fault == "token_altered" and self.calls == 4:
            logits = logits.roll(1, dims=-1)
        return logits, new_state


def _run(workload, seed, fault=None):
    cell = small_cell(workload, sample_requests=64)
    cell.limits = {"logit_gap": {"limit": LIMIT}}
    if fault:
        mode = cell.mode()
        broken = types.SimpleNamespace(
            setup=lambda cfg, params, dev: Faulty(mode.setup(cfg, params, dev), fault))
        cell.mode = lambda: broken
    result, _ = runner.run(cell, seed, 0.05, False, "cpu", time.perf_counter())
    return result


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_run_is_correct(workload):
    r = _run(workload, 2 ** 34 + 3)
    assert r["correct"] and r["failed"] == 0
    assert list(r)[-1] == "checks" and r["checks"]["logit_gap"]["limit"] == LIMIT
    assert r["attempted"] >= 4


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_fault_is_not_correct(workload, fault):
    r = _run(workload, 2 ** 34 + 3, fault)
    assert not r["correct"] and r["failed"] > 0
    assert r["checks"]["logit_gap"]["value"] > LIMIT


def test_ring_runs_on_the_cpu_and_holds():
    """The ring mode's whole run at reduced size: the store built, the
    ring decoding every layer, the reference holding its tokens."""
    cell = small_cell("yi_6b.ring-b64-c2k", output_tokens=3, warmup_steps=1)
    cell.limits = {"logit_gap": {"limit": LIMIT}}
    result, rec = runner.run(cell, 5, 0.01, False, "cpu", time.perf_counter())
    assert result["correct"]
    assert 60 < 100 * rec["counters"]["comp_bytes"] / rec["counters"]["raw_bytes"] < 80
