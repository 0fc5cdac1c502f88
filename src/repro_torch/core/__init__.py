# The paper's primary contribution — the LightKernel persistent execution
# model (mailbox protocol, persistent and megakernel runtimes, cluster
# pinning, dispatcher, WCET accounting) — ported to PyTorch. Counterpart of
# ``repro.core``, less ``make_cluster_mesh`` (the distribution slice).
from repro_torch.core import mailbox
from repro_torch.core.clusters import Cluster, ClusterManager
from repro_torch.core.dispatcher import (AdmissionError, AllClustersFailed,
                                         Completion, Dispatcher, Ticket,
                                         TicketCancelled)
from repro_torch.core.elastic import ElasticController
from repro_torch.core.persistent import (ExecutableCache, PersistentRuntime,
                                         RuntimeProtocol, TraditionalRuntime)
from repro_torch.core.system import LkSystem, WorkClass
from repro_torch.core.wcet import WcetTracker

__all__ = [
    "mailbox", "Cluster", "ClusterManager",
    "AdmissionError", "AllClustersFailed", "Completion", "Dispatcher",
    "ElasticController", "ExecutableCache",
    "Ticket", "TicketCancelled", "LkSystem", "WorkClass",
    "PersistentRuntime", "RuntimeProtocol", "TraditionalRuntime",
    "WcetTracker",
]
