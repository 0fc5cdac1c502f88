"""The share of the traced window in which the card sat idle while the
host issued a decode step: the idle gaps that began inside a decode
trigger span, at any depth, over the window (``program_spans``)."""


def read(run):
    prog = (run.trace or {}).get("program")
    if not prog or prog["window_s"] <= 0:
        return None
    return 100.0 * prog["idle_issue_s"] / prog["window_s"]
