"""Host syncs a decode step: calls to cudaDeviceSynchronize,
cudaStreamSynchronize, cudaEventSynchronize and aten::_local_scalar_dense
(one inside another counted once) that decode triggers starting in the
traced window hold, over those triggers (``program_spans``)."""


def read(run):
    prog = (run.trace or {}).get("program")
    return prog["decode_syncs"] if prog else None
