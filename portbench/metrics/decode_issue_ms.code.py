"""Host time to issue one decode step: the mean duration of the program's
decode trigger spans (``repro_torch.rt.trigger.<work>`` with ``decode``
among its works) that start in the traced window (``program_spans``)."""


def read(run):
    prog = (run.trace or {}).get("program")
    return prog["decode_issue_ms"] if prog else None
