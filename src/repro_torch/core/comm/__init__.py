"""repro_torch.core.comm — the first-class communication-interface layer.

The paper's conceptual contribution, made explicit (§2.3, §3.3; companion
proposal arXiv 2503.15400):

* :mod:`.interface` — the unified :class:`CommInterface` contract
  (``post_send / post_recv / post_put_signal / progress / poll``),
  :class:`PostStatus` backpressure results, :class:`Capabilities`
  descriptors, and the :class:`CompletionTarget` completion surface.
* :mod:`.resources` — :class:`ResourceLimits`, the single shared model of
  finite communication resources consumed by the fabric and the
  parcelports.
* :mod:`.base` — :class:`ParcelportBase`: aggregation + backpressure
  retry/throttle machinery shared by every parcelport.
* :mod:`.progress` — the shared :class:`ProgressEngine`; :mod:`.wire` —
  the gradient wire and the control-plane codec; :mod:`.membership` — the
  member lifecycle (:class:`Membership`).
* :mod:`.registry` — the composable variant registry (fixed names +
  parameterized families such as ``lci_b{depth}``); :mod:`.collective` and
  :mod:`.shmem` — the collective and shared-memory transports under
  :class:`CommChannel` and their parcelports.  These three are imported
  lazily to keep this package a leaf for the modules below it.
"""
from .base import (
    InjectionThrottle,
    ParcelportBase,
    aggregate_parcels,
    aggregate_projected_bytes,
    is_aggregate,
    split_aggregate,
)
from .interface import (
    Capabilities,
    CommInterface,
    CompletionTarget,
    PostStatus,
    UnsupportedCapabilityError,
    complete,
)
from .membership import Membership
from .progress import ProgressEngine, ProgressPolicy, run_step
from .resources import ResourceLimits
from .wire import decode_msg, encode_msg

__all__ = [
    "Capabilities",
    "CommInterface",
    "CompletionTarget",
    "Membership",
    "ParcelportBase",
    "PostStatus",
    "ProgressEngine",
    "ProgressPolicy",
    "ResourceLimits",
    "UnsupportedCapabilityError",
    "VariantRegistry",
    "VariantSpec",
    "RegistryView",
    "UnknownVariantError",
    "CollectiveComm",
    "CollectiveGroup",
    "CollectiveParcelport",
    "CommChannel",
    "ShmemComm",
    "ShmemGroup",
    "ShmemParcelport",
    "InjectionThrottle",
    "aggregate_parcels",
    "aggregate_projected_bytes",
    "complete",
    "decode_msg",
    "encode_msg",
    "is_aggregate",
    "run_step",
    "split_aggregate",
]

_REGISTRY_NAMES = {"VariantRegistry", "VariantSpec", "RegistryView", "UnknownVariantError"}
_COLLECTIVE_NAMES = {"CollectiveComm", "CollectiveGroup", "CollectiveParcelport", "CommChannel"}
_SHMEM_NAMES = {"ShmemComm", "ShmemGroup", "ShmemParcelport"}


def __getattr__(name: str):
    # Lazy: registry is pure machinery, and the collective and shared-memory
    # backends import the parcelport layer above this package — importing
    # them eagerly would make every `from .comm.base import ...` in lower
    # layers pay for it (or cycle).
    if name in _REGISTRY_NAMES:
        from . import registry

        return getattr(registry, name)
    if name in _COLLECTIVE_NAMES:
        from . import collective

        return getattr(collective, name)
    if name in _SHMEM_NAMES:
        from . import shmem

        return getattr(shmem, name)
    raise AttributeError(name)
