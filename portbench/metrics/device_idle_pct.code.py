"""100 less the share of the traced window in which some operation ran on
the device (the union of the device's busy intervals)."""


def read(run):
    if not run.trace or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
