"""The prefill's share of the card's peak: the least time of every host
prefill in the window (portbench.work) over the device time launched
inside the ``portbench.prefill`` spans (traced run)."""
from portbench import work


def read(run):
    if not run.trace:
        return None
    dev = run.trace["device_s_by_span"].get("portbench.prefill", 0.0)
    pk = work.peak(run.device_kind)
    least = sum(work.least_s(work.prefill(run.model, L), pk)
                for t, L in run.prefills if run.in_window(t))
    return 100.0 * least / dev if dev > 0 and least > 0 else None
