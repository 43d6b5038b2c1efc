"""Composable variant registry: fixed names + parameterized families.

The paper's evaluated configurations (Figs 3-9) used to live in one
hard-coded dict, which meant every new axis (device counts, eager
thresholds, resource-limit depths) had to be *enumerated* up front.  This
registry composes instead: a :class:`VariantSpec` describes a whole family
with a name grammar (``lci_d{n}``, ``lci_eager_{k}k``, ``lci_b{depth}``)
and a builder, and any member — ``lci_d7``, ``lci_b8`` — resolves on
demand, without pre-registration.  A small set of *canonical* members per
family keeps ``variant_names()`` (and the docs/variant-table gate, the
smoke gate, and benchmark sweeps) finite and stable.

The machinery is config-type-agnostic; :mod:`repro_torch.core.variants` defines
the concrete axes over :class:`~repro_torch.core.lci_parcelport.LCIPPConfig` and
re-exports the registry under the legacy ``VARIANTS`` mapping name.
Resolution is cached, so resolving the same name twice returns the *same*
config object (configs are treated as immutable-by-convention, like the
old dict entries).
"""
from __future__ import annotations

import re
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterator, List, Mapping, Optional, Tuple

__all__ = ["VariantSpec", "VariantRegistry", "RegistryView", "UnknownVariantError"]


class UnknownVariantError(KeyError):
    """Name matched neither a fixed variant nor any family grammar."""


@dataclass(frozen=True)
class VariantSpec:
    """One parameterized family of variants.

    * ``grammar`` — the documented name pattern, e.g. ``"lci_b{depth}"``.
      Every ``{placeholder}`` matches a decimal integer; the surrounding
      literal text matches itself.  This exact string also appears in
      docs/VARIANTS.md, where ``tools/check_docs.py`` expands it the same
      way, so the docs and the resolver share one grammar.
    * ``build(name, **params)`` — constructs the config for a resolved
      member; params arrive as ints keyed by placeholder name.
    * ``canonical`` — the parameter tuples enumerated by
      ``VariantRegistry.names()`` (each tuple in grammar order).
    * ``doc`` — one-line description for tooling.
    """

    grammar: str
    build: Callable[..., Any]
    canonical: Tuple[Tuple[int, ...], ...] = ()
    doc: str = ""
    _regex: re.Pattern = field(init=False, repr=False, compare=False)
    _params: Tuple[str, ...] = field(init=False, repr=False, compare=False)

    def __post_init__(self) -> None:
        params: List[str] = []

        def to_group(m: re.Match) -> str:
            params.append(m.group(1))
            return f"(?P<{m.group(1)}>\\d+)"

        pattern = "".join(
            to_group(part) if (part := _PLACEHOLDER.fullmatch(piece)) else re.escape(piece)
            for piece in _PLACEHOLDER_SPLIT.split(self.grammar)
            if piece
        )
        object.__setattr__(self, "_regex", re.compile(pattern))
        object.__setattr__(self, "_params", tuple(params))

    @property
    def regex(self) -> re.Pattern:
        """The compiled name grammar — the single source shared with
        tooling (``tools/check_docs.py`` matches documented family rows
        against exactly this pattern)."""
        return self._regex

    def match(self, name: str) -> Optional[Dict[str, int]]:
        m = self._regex.fullmatch(name)
        if m is None:
            return None
        return {k: int(v) for k, v in m.groupdict().items()}

    def member_name(self, values: Tuple[int, ...]) -> str:
        name = self.grammar
        for param, value in zip(self._params, values):
            name = name.replace("{" + param + "}", str(value))
        return name


_PLACEHOLDER = re.compile(r"\{(\w+)\}")
_PLACEHOLDER_SPLIT = re.compile(r"(\{\w+\})")


class VariantRegistry:
    """Fixed variants + family specs, resolved lazily and cached."""

    def __init__(self) -> None:
        self._fixed: Dict[str, Callable[[], Any]] = {}
        self._families: List[VariantSpec] = []
        self._cache: Dict[str, Any] = {}
        self._lock = threading.Lock()

    # -- registration -------------------------------------------------------
    def register(self, name: str, build: Callable[[], Any]) -> None:
        """Register one fixed variant (lazily built on first resolve)."""
        self._fixed[name] = build

    def register_family(self, spec: VariantSpec) -> VariantSpec:
        self._families.append(spec)
        return spec

    # -- resolution ---------------------------------------------------------
    def resolve(self, name: str) -> Any:
        """Resolve any variant name — fixed or family member — to its
        config.  Cached: the same name always yields the same object."""
        with self._lock:
            cfg = self._cache.get(name)
            if cfg is not None:
                return cfg
            cfg = self._build(name)
            self._cache[name] = cfg
            return cfg

    def _build(self, name: str) -> Any:
        build = self._fixed.get(name)
        if build is not None:
            return build()
        for spec in self._families:
            params = spec.match(name)
            if params is not None:
                return spec.build(name, **params)
        raise UnknownVariantError(name)

    def __contains__(self, name: object) -> bool:
        if not isinstance(name, str):
            return False
        if name in self._fixed:
            return True
        return any(spec.match(name) is not None for spec in self._families)

    # -- enumeration --------------------------------------------------------
    def names(self) -> List[str]:
        """Fixed names plus each family's canonical members, sorted."""
        out = set(self._fixed)
        for spec in self._families:
            for values in spec.canonical:
                out.add(spec.member_name(values))
        return sorted(out)

    def families(self) -> List[VariantSpec]:
        return list(self._families)


class RegistryView(Mapping):
    """Legacy dict-compatible view over a :class:`VariantRegistry`.

    Supports everything the old hard-coded ``VARIANTS`` dict supported —
    ``VARIANTS[name]``, ``name in VARIANTS``, ``sorted(VARIANTS)`` — while
    ``__getitem__`` additionally resolves parameterized family members on
    demand (``VARIANTS["lci_b8"]`` works without pre-registration).
    Iteration yields only the canonical names, keeping enumeration finite.
    """

    def __init__(self, registry: VariantRegistry):
        self._registry = registry

    def __getitem__(self, name: str) -> Any:
        try:
            return self._registry.resolve(name)
        except UnknownVariantError:
            raise KeyError(name) from None

    def __contains__(self, name: object) -> bool:
        return name in self._registry

    def __iter__(self) -> Iterator[str]:
        return iter(self._registry.names())

    def __len__(self) -> int:
        return len(self._registry.names())
