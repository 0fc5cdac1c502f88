"""A whole run at a test size on the CPU (the look for a card skipped):
correct when the timed path is sound, not correct with the timed path
broken underneath, and the control (the float8 reference in the
program's place) not correct either."""
import time
import warnings

import pytest

from portbench import checks, serve
from portbench.run import run_cell
from portbench.tests import tiny

warnings.filterwarnings("ignore", category=RuntimeWarning)


def _run(seconds=2.0, trace=False):
    return run_cell(tiny.cell(), 2**31 + 77, seconds, trace, "cpu",
                    time.time())


def _plant(monkeypatch, fault):
    wrap = serve.System._wrap

    def planted(self):
        wrap(self)
        fault(self)
    monkeypatch.setattr(serve.System, "_wrap", planted)


def _state_unchanged(system):
    """Decode steps leave the caches as they found them."""
    d = system.model.decode_step

    def step(params, caches, tokens, positions):
        clone = {k: {n: t.clone() for n, t in v.items()}
                 for k, v in caches.items()}
        logits, _ = d(params, clone, tokens, positions)
        return logits, caches
    system.model.decode_step = step


def _half_batch(system):
    """The second half of the slots gets the first half's results."""
    d = system.model.decode_step

    def step(params, caches, tokens, positions):
        logits, c = d(params, caches, tokens, positions)
        B = logits.shape[0]
        logits[B // 2:] = logits[:B - B // 2].clone()
        return logits, c
    system.model.decode_step = step


def _token_altered(system):
    """Each decode step changes the last slot's token where it is
    produced."""
    d = system.model.decode_step

    def step(params, caches, tokens, positions):
        logits, c = d(params, caches, tokens, positions)
        top = int(logits[-1, 0].argmax())
        logits[-1, 0, (top + 1) % logits.shape[-1]] += 1e3
        return logits, c
    system.model.decode_step = step


def _first_token_altered(system):
    p = system.model.prefill

    def prefill(params, batch, max_seq):
        logits, c = p(params, batch, max_seq)
        logits[:, -1, (logits[:, -1].argmax(-1) + 3) % logits.shape[-1]] \
            += 1e3
        return logits, c
    system.model.prefill = prefill


def test_sound_run_is_correct():
    out = _run(trace=True)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] >= 0
    assert out["device"]["platform"] == "cpu"
    names = {m["name"] for m in tiny.cell().per_layer
             if m["source"] != "device_trace"}
    assert names <= set(out["metrics"])
    assert out["checks"]["judged"]["value"] >= 24
    assert list(out)[-4:] == ["checks", "_run", "_numbers", "_material"]


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch,
                                   _token_altered, _first_token_altered])
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    _plant(monkeypatch, fault)
    out = _run()
    assert not out["correct"], (fault.__name__, out["checks"])


def test_lead_in_is_served_before_the_window():
    """The lead-in's requests are served before the window opens and
    count neither as attempted nor in the check's sample."""
    cell = tiny.cell()
    cell.traffic = dict(cell.traffic, lead_in_s=1.0)
    out = run_cell(cell, 2**31 + 78, 2.0, False, "cpu", time.time())
    run = out["_run"]
    lead = [r for r in run.streams if r.due < run.t0]
    assert lead and all(r.closed is not None for r in lead)
    assert out["attempted"] == len(run.streams) - len(lead) == 12
    assert out["correct"], out["checks"]
    window = [r.req.prompt for r in run.streams if r.due >= run.t0]
    assert all(any(p is q for q in window) for p, _, _ in out["_material"])


def test_too_few_judged_tokens_is_not_correct():
    cell = tiny.cell()
    cell.checks["min_judged"] = 10**6
    out = run_cell(cell, 2**31 + 77, 2.0, False, "cpu", time.time())
    assert not out["correct"], out["checks"]


def test_the_control_is_not_correct():
    cell = tiny.cell()
    out = run_cell(cell, 9, 2.0, False, "cpu", time.time())
    finished = out["_material"]
    assert finished
    # the same material, judged for the program and for the control
    got = checks.compare(cell.config, 9, "cpu", finished, control=True)
    ok_prog, _ = checks.verdict(got["program"], cell.checks)
    ok_ctl, shown = checks.verdict(got["control"], cell.checks)
    assert ok_prog and not ok_ctl, shown
