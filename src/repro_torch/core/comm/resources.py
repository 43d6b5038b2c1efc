"""The shared resource model (paper §3.3.4).

One dataclass names every finite communication resource the reproduction
bounds, and *every* layer consumes it: the functional fabric
(:class:`repro.core.fabric.Fabric`) sizes its descriptor rings and
registered bounce-buffer pools from it, the LCI parcelport draws its retry
throttle from it, and the DES model (:class:`repro.amtsim.parcelport_sim.
SimConfig`) carries the *same object* — so the functional and performance
experiments can never drift apart field by field, which is what the old
hand-mirrored ``SimConfig.send_queue_depth``/``bounce_buffers``/... lists
allowed.  ``tools/check_api.py`` gates against the mirror re-growing.

All limits default to 0 = unbounded (the classic model); a config opts in
explicitly, exactly as the paper's §3.3.4 describes real NICs forcing
libraries to.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

__all__ = ["ResourceLimits"]


@dataclass(frozen=True)
class ResourceLimits:
    """Finite communication resources, shared by every layer.

    * ``send_queue_depth`` — per-device descriptor ring (0 = unbounded).
      A send occupies its slot from post until the send completion is
      reaped; a full ring refuses posts ``EAGAIN_QUEUE``-style.
    * ``bounce_buffers`` × ``bounce_buffer_size`` — the pool of
      pre-registered bounce buffers eager messages copy through (0 buffers
      = no pool).  An empty pool refuses eager posts ``EAGAIN_BUFFER``.
    * ``retry_budget`` — backpressured posts a parcelport retries per
      ``background_work`` call (the sender-side throttle).
    * ``recv_slots`` — pre-posted receive descriptors per device (0 =
      effectively unlimited).  Arrivals beyond the posted depth are RNR
      (receiver-not-ready) events: counted, and retried by hardware
      progress rather than lost.
    """

    send_queue_depth: int = 0
    bounce_buffers: int = 0
    bounce_buffer_size: int = 64 * 1024
    retry_budget: int = 8
    recv_slots: int = 0

    @property
    def bounded(self) -> bool:
        """True when injection is bounded (ring or pool finite)."""
        return self.send_queue_depth > 0 or self.bounce_buffers > 0

    def variant(self, **kw) -> "ResourceLimits":
        return replace(self, **kw)
