"""The port's copy of the communication-interface layer the serving path
rides (paper §2.3, §3.3): the five-verb :class:`CommInterface` contract,
:class:`ResourceLimits`, the shared :class:`ProgressEngine`, the
control-plane codec, the collective and shared-memory transports under
:class:`CommChannel`, and the member lifecycle (:class:`Membership`)."""
from .collective import CollectiveComm, CollectiveGroup, CommChannel
from .interface import Capabilities, CommInterface, CompletionTarget, PostStatus, UnsupportedCapabilityError, complete
from .membership import Membership
from .progress import ProgressEngine, ProgressPolicy, run_step
from .resources import ResourceLimits
from .shmem import ShmemComm, ShmemGroup
from .wire import decode_msg, encode_msg

__all__ = [
    "Capabilities",
    "CollectiveComm",
    "CollectiveGroup",
    "CommChannel",
    "CommInterface",
    "CompletionTarget",
    "Membership",
    "PostStatus",
    "ProgressEngine",
    "ProgressPolicy",
    "ResourceLimits",
    "ShmemComm",
    "ShmemGroup",
    "UnsupportedCapabilityError",
    "complete",
    "decode_msg",
    "encode_msg",
    "run_step",
]
