"""The port's runtime race checker (:mod:`.sanitizer`).

Of the reference's ``repro.analysis`` the port keeps the runtime half
only: the lockset sanitizer its membership table and shared-memory
transport report their accesses to.  The static passes read the JAX
package's sources and stay there.
"""
from . import sanitizer

__all__ = ["sanitizer"]
