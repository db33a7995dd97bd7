"""Deterministic, seed-driven fault injection.

The JAX package's ``resilience/chaos.py``, copied: the same ``CHAOS_SPEC``
environment variable, grammar and list of known sites, so one spec means
the same to both packages. The spec is a comma-separated list:

    CHAOS_SPEC="seed=7,kernel_compile=2"

- ``seed=N``     RNG seed for probabilistic sites (default 0).
- ``<site>=N``   fail the first N draws at that site, then heal.
- ``<site>=pX``  each draw at that site fails with probability X, from a
                 per-site stream seeded by (seed, site).

An unknown site is a ``ValueError`` naming the valid kinds, so a typo'd
drill fails loudly instead of never firing. The port draws at three sites:

- ``kernel_compile``: once per timed candidate of the autotuner
  (``tuning.autotune.tune_layer``), which records the candidate as failed
  and sweeps on (a layer whose candidates all fail degrades to the default
  variants), and once per build of a kernel-tier config in ``run.py``,
  which fails that build (``--max-retries`` retries it, ``--fallback-chain``
  degrades to the next tier);
- ``host_loss``: ``serving.fleet.maybe_host_loss`` SIGKILLs backend
  ``seed % n`` of a fleet (``run --serve --route``, ``BENCH_MODE=route``);
- ``fleet_pressure``: ``serving.loadgen.maybe_fleet_pressure`` swaps a
  fleet's load for the correlated diurnal swell
  (``BENCH_MODE=fleetcontrol``).

The other sites are listed so a spec written for the JAX package parses
here too.

Counters are per process.
"""

from __future__ import annotations

import dataclasses
import os
import random
from typing import Dict, Optional

CHAOS_ENV = "CHAOS_SPEC"

# Every injectable fault kind, in consumer order (see module docstring).
# ``ChaosSpec.parse`` validates against this list so a typo'd drill fails
# loudly instead of silently never firing.
KNOWN_SITES = (
    "collective",
    "device_loss",
    "kernel_compile",
    "subprocess_wedge",
    "ssh",
    "rsync",
    "sdc",
    "nan_loss",
    "stage_sdc",
    "mesh_shrink",
    "device_rejoin",
    "flap",
    "host_loss",
    "fleet_pressure",
)


class InjectedFault(RuntimeError):
    """A fault manufactured by the chaos layer — never raised by real code,
    so recovery paths can tell drills from genuine failures in logs."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"chaos: injected {site} fault" + (f" ({detail})" if detail else ""))
        self.site = site


@dataclasses.dataclass(frozen=True)
class ChaosSpec:
    """Parsed CHAOS_SPEC: count-based and probabilistic sites."""

    seed: int = 0
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)
    probs: Dict[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, text: str) -> "ChaosSpec":
        seed, counts, probs = 0, {}, {}
        for item in (text or "").split(","):
            item = item.strip()
            if not item:
                continue
            if "=" not in item:
                raise ValueError(f"malformed CHAOS_SPEC item {item!r} (want site=N|pX)")
            site, _, val = item.partition("=")
            site, val = site.strip(), val.strip()
            if site != "seed" and site not in KNOWN_SITES:
                raise ValueError(
                    f"unknown CHAOS_SPEC fault kind {site!r} "
                    f"(valid kinds: seed, {', '.join(KNOWN_SITES)})"
                )
            if site == "seed":
                seed = int(val)
            elif val.startswith("p"):
                p = float(val[1:])
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"CHAOS_SPEC {site}={val}: probability outside [0,1]")
                probs[site] = p
            else:
                counts[site] = int(val)
        return cls(seed=seed, counts=counts, probs=probs)

    @property
    def empty(self) -> bool:
        return not self.counts and not self.probs


class ChaosInjector:
    """Stateful per-process injector over a ChaosSpec."""

    def __init__(self, spec: ChaosSpec):
        self.spec = spec
        self._remaining = dict(spec.counts)
        self._rng = {
            site: random.Random(f"{spec.seed}:{site}") for site in spec.probs
        }
        self.fired: Dict[str, int] = {}

    def draw(self, site: str) -> bool:
        """True = inject a fault at this site now. Count-based sites burn
        down; probabilistic sites draw from their seeded stream."""
        hit = False
        if self._remaining.get(site, 0) > 0:
            self._remaining[site] -= 1
            hit = True
        elif site in self._rng:
            hit = self._rng[site].random() < self.spec.probs[site]
        if hit:
            self.fired[site] = self.fired.get(site, 0) + 1
        return hit

    def drain(self, site: str) -> int:
        """Consume and return ALL remaining count-based hits at ``site``
        (0 when none). For sites where the spec's count is a magnitude one
        event carries (``mesh_shrink=k`` drops k devices in ONE shrink)
        rather than N separate transient faults. Probabilistic sites are
        untouched — their per-draw stream still fires via ``draw``."""
        n = self._remaining.pop(site, 0)
        if n > 0:
            self.fired[site] = self.fired.get(site, 0) + n
        return n

    def maybe_raise(self, site: str, detail: str = "") -> None:
        if self.draw(site):
            raise InjectedFault(site, detail)


# Process-wide injector, cached per CHAOS_SPEC value so counters persist
# across call sites within one process but a test's monkeypatched env takes
# effect immediately.
_cached: Optional[tuple] = None  # (spec_text, injector)


def active() -> Optional[ChaosInjector]:
    """The process injector, or None when CHAOS_SPEC is unset/empty —
    callers guard with ``ch = active();  if ch and ch.draw(...)`` so the
    chaos-off hot path costs one env read."""
    global _cached
    text = os.environ.get(CHAOS_ENV, "")
    if not text.strip():
        _cached = None
        return None
    if _cached is None or _cached[0] != text:
        _cached = (text, ChaosInjector(ChaosSpec.parse(text)))
    return _cached[1]


def reset() -> None:
    """Forget the cached injector (tests: fresh counters per case)."""
    global _cached
    _cached = None
