"""K5 (prefill attention) at its roofline: the least time of every
layer's causal attention over each prompt prefilled in the window, over
the device time of K5's kernels by name."""
from portbench import work


def read(run):
    if not run.trace:
        return None
    dev = run.trace["kernel_s"].get("k5", 0.0)
    pk = work.peak(run.device_kind)
    least = run.model["num_layers"] * sum(
        work.least_s(work.k5(run.model, L), pk)
        for t, L in run.prefills if run.in_window(t))
    return 100.0 * least / dev if dev > 0 and least > 0 else None
