"""Top-level alias for the system facade: the ROADMAP-facing entry point.

    from repro_torch.system import LkSystem, WorkClass
"""
from repro_torch.core.dispatcher import AdmissionError, Ticket, TicketCancelled
from repro_torch.core.elastic import ElasticController
from repro_torch.core.sched import CRIT_HIGH, CRIT_LOW, ClassSpec
from repro_torch.core.system import LkSystem, WorkClass

__all__ = ["AdmissionError", "CRIT_HIGH", "CRIT_LOW", "ClassSpec",
           "ElasticController", "LkSystem", "Ticket", "TicketCancelled",
           "WorkClass"]
