"""repro_torch.core — the paper's contribution: the HPX/LCI communication stack.

Layers (bottom-up, mirroring paper Fig 2):

* :mod:`repro_torch.core.fabric` — native network layer (libibverbs semantics).
* :mod:`repro_torch.core.device`, :mod:`repro_torch.core.completion` — the
  communication-library layer (LCI): devices, completion objects, progress.
* :mod:`repro_torch.core.mpi_sim` — MPI emulation with its interface limitations.
* :mod:`repro_torch.core.parcelport`, :mod:`repro_torch.core.mpi_parcelport`,
  :mod:`repro_torch.core.lci_parcelport`, :mod:`repro_torch.core.variants` — the HPX
  adaptation layer and the paper's studied configurations.
* :mod:`repro_torch.core.executor` — the AMT worker runtime (HPX threads).
* :mod:`repro_torch.core.comm` — the first-class communication-interface layer:
  the unified :class:`CommInterface` contract, :class:`PostStatus`
  backpressure, :class:`Capabilities`, the shared :class:`ResourceLimits`
  resource model, and the composable variant registry.
"""
from .comm import (
    Capabilities,
    CommInterface,
    CompletionTarget,
    ParcelportBase,
    PostStatus,
    ResourceLimits,
    UnsupportedCapabilityError,
)
from .completion import (
    LCRQueue,
    LockQueue,
    MichaelScottQueue,
    Synchronizer,
    SynchronizerPool,
    make_completion_queue,
)
from .device import LCIDevice, LockMode
from .executor import AMTExecutor, TaskFuture
from .fabric import Fabric, NetDevice
from .lci_parcelport import LCIParcelport, LCIPPConfig
from .mpi_parcelport import MPIParcelport
from .parcel import Chunk, Parcel, deserialize_action, serialize_action
from .parcelport import Locality, Parcelport, World
from .variants import (
    VARIANTS,
    make_parcelport_factory,
    max_devices,
    variant_limits,
    variant_names,
)

__all__ = [
    "AMTExecutor",
    "Capabilities",
    "Chunk",
    "CommInterface",
    "CompletionTarget",
    "Fabric",
    "LCIDevice",
    "LCIParcelport",
    "LCIPPConfig",
    "LCRQueue",
    "LockMode",
    "LockQueue",
    "Locality",
    "MPIParcelport",
    "MichaelScottQueue",
    "NetDevice",
    "Parcel",
    "Parcelport",
    "ParcelportBase",
    "PostStatus",
    "ResourceLimits",
    "Synchronizer",
    "SynchronizerPool",
    "TaskFuture",
    "UnsupportedCapabilityError",
    "VARIANTS",
    "World",
    "deserialize_action",
    "make_completion_queue",
    "make_parcelport_factory",
    "max_devices",
    "serialize_action",
    "variant_limits",
    "variant_names",
]
