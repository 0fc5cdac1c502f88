"""Device time of a host prefill: the device time of what was launched
inside the ``portbench.prefill`` spans, over the prefills in the window
(traced run)."""


def read(run):
    if not run.trace:
        return None
    n = sum(1 for t, _ in run.prefills if run.in_window(t))
    s = run.trace["device_s_by_span"].get("portbench.prefill", 0.0)
    return s * 1e3 / n if n and s > 0 else None
