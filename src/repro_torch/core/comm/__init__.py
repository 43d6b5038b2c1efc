"""The port's copy of the communication-interface layer the serving path
rides (paper §2.3, §3.3): the five-verb :class:`CommInterface` contract,
:class:`ResourceLimits`, the shared :class:`ProgressEngine`, the
control-plane codec, and the loopback :class:`CommChannel`."""
from .collective import CollectiveComm, CollectiveGroup, CommChannel
from .interface import Capabilities, CommInterface, CompletionTarget, PostStatus, UnsupportedCapabilityError, complete
from .progress import ProgressEngine, ProgressPolicy, run_step
from .resources import ResourceLimits
from .wire import decode_msg, encode_msg

__all__ = [
    "Capabilities",
    "CollectiveComm",
    "CollectiveGroup",
    "CommChannel",
    "CommInterface",
    "CompletionTarget",
    "PostStatus",
    "ProgressEngine",
    "ProgressPolicy",
    "ResourceLimits",
    "UnsupportedCapabilityError",
    "complete",
    "decode_msg",
    "encode_msg",
    "run_step",
]
