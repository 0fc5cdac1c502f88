# The paper's primary contribution — the LightKernel persistent execution
# model (mailbox protocol, persistent runtime, dispatcher, WCET accounting)
# — ported to PyTorch. Counterpart of ``repro.core``; cluster carving, the
# megakernel runtime and the LkSystem facade are not ported yet.
from repro_torch.core import mailbox
from repro_torch.core.dispatcher import (AdmissionError, AllClustersFailed,
                                         Completion, Dispatcher, Ticket,
                                         TicketCancelled)
from repro_torch.core.persistent import PersistentRuntime, RuntimeProtocol
from repro_torch.core.wcet import WcetTracker

__all__ = [
    "mailbox", "AdmissionError", "AllClustersFailed", "Completion",
    "Dispatcher", "Ticket", "TicketCancelled", "PersistentRuntime",
    "RuntimeProtocol", "WcetTracker",
]
