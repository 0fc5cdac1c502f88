"""Named host spans on the profiler's clock.

``span(name, args)`` opens a range while a ``torch.profiler`` session is
recording and returns one shared no-op context otherwise, so a site costs
one check when nobody profiles. There is no switch of its own: an operator
gets the spans by running the server under ``torch.profiler``.

A range is one of the profiler's CPU events, stamped on kineto's clock
(the device trace's), so the aten ops and CUDA runtime calls issued inside
it nest in it by time and each gap on the device can be put down to what
the host was doing. The ranges are recorded as plain CPU ranges
(``_RecordFunctionFast``) and not as ``record_function``'s user
annotations: kineto copies a user annotation onto the device timeline,
over the kernels launched inside it, and such a copy of a span that holds
host gaps reads as device work to any reduction that unions device
intervals.

The serving path's spans:

* ``repro_torch.streams.poll`` — ``StreamFrontend.poll``;
* ``repro_torch.engine.step`` — ``ServingEngine.step`` (its request id);
* ``repro_torch.engine.prefill`` — the host prefill in ``add_request``;
* ``repro_torch.rt.trigger.<work>`` — ``PersistentRuntime.trigger`` and
  ``trigger_many`` (``<work>``: the work table's names of a ring's items,
  joined by ``+`` in ring order when they differ);
* ``repro_torch.rt.wait.<work>`` — ``_PipelinedRuntime.wait`` (the work
  name of the item it retires; plain ``repro_torch.rt.wait`` where the
  runtime keeps no descriptors, as the megakernel runtime);
* ``repro_torch.model.layer`` — each ``layer_apply`` of
  ``transformer.forward_stack`` (prefill and decode).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_OFF = contextlib.nullcontext()


def span(name, request_id: Optional[int] = None):
    """A profiler range while a profiler records, else a shared no-op
    context. ``name``: the range's name, or a callable that makes it,
    called only while a profiler records; ``request_id``: recorded as the
    range's keyword input."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    if callable(name):
        name = name()
    if request_id is None:
        return torch._C._profiler._RecordFunctionFast(name)
    return torch._C._profiler._RecordFunctionFast(
        name, (), {"request_id": request_id})
