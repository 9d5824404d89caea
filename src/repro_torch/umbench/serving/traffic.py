"""Seeded request-arrival generators for the serving tier (DESIGN.md §13):
the port's copy of ``repro.umbench.serving.traffic``.

A :class:`TrafficPattern` turns ``(seed, salt)`` into a finite stream of
:class:`Request` objects — arrival time, prompt length, generation length —
through one of three arrival processes:

  * ``poisson``   homogeneous Poisson arrivals (exponential gaps);
  * ``bursty``    Markov-modulated Poisson: a two-state (burst/idle) chain
                  whose states multiply the base rate, switching with a
                  per-arrival probability — request trains with gaps;
  * ``diurnal``   a nonhomogeneous Poisson whose rate swings geometrically
                  between ``rate/peak_to_trough`` and ``rate*peak_to_trough``
                  on a sinusoidal period — load peaks and troughs.

Determinism mirrors ``core/faults.FaultInjector``: the RNG is
``random.Random`` seeded by blake2s-mixing ``pattern.seed`` with a salt (the
sweep salts with the serving cell key), so the same pattern generates the
same trace in every process regardless of PYTHONHASHSEED or pool
scheduling.  Patterns are frozen dataclasses in a registry
(:data:`PATTERNS`), resolved by name exactly like fault scenarios and
variant strategies.
"""
from __future__ import annotations

import dataclasses
import math
import random

from repro_torch.core.faults import _mix_seed

__all__ = [
    "PATTERNS",
    "Request",
    "TrafficPattern",
    "get_pattern",
    "pattern_names",
]


@dataclasses.dataclass(frozen=True)
class Request:
    """One inference request: arrives at ``arrival_s``, carries a
    ``prompt_len``-token prompt, and decodes ``gen_len`` tokens."""

    rid: int
    arrival_s: float
    prompt_len: int
    gen_len: int

    @property
    def total_tokens(self) -> int:
        """The request's full KV footprint, in tokens (prompt + gen)."""
        return self.prompt_len + self.gen_len


@dataclasses.dataclass(frozen=True)
class TrafficPattern:
    """One named, seeded arrival process.  ``rate_rps`` is the *mean* rate
    for every kind; the bursty/diurnal parameters shape how arrivals bunch
    around it.  Lengths are lognormal around ``prompt_mean``/``gen_mean``
    (sigma = ``len_sigma``), clamped to sane token ranges."""

    name: str
    kind: str                       # poisson | bursty | diurnal
    rate_rps: float = 6.0
    n_requests: int = 48
    seed: int = 0
    prompt_mean: int = 1536
    gen_mean: int = 96
    len_sigma: float = 0.4
    prompt_clamp: tuple[int, int] = (64, 4096)
    gen_clamp: tuple[int, int] = (16, 256)
    # bursty (two-state Markov-modulated Poisson)
    burst_factor: float = 6.0       # rate multiplier in the burst state
    idle_factor: float = 0.2        # rate multiplier in the idle state
    switch_prob: float = 0.15       # P(state flips | arrival)
    # diurnal (sinusoidal rate modulation)
    period_s: float = 8.0
    peak_to_trough: float = 4.0

    def _rate_at(self, t: float) -> float:
        """Instantaneous diurnal rate: geometric sinusoidal swing between
        ``rate/peak_to_trough`` and ``rate*peak_to_trough``."""
        return self.rate_rps * self.peak_to_trough ** math.sin(
            2.0 * math.pi * t / self.period_s)

    def _length(self, rng: random.Random, mean: int,
                clamp: tuple[int, int]) -> int:
        # lognormal with E[X] = mean: mu = ln(mean) - sigma^2/2
        mu = math.log(mean) - 0.5 * self.len_sigma ** 2
        return min(clamp[1], max(clamp[0],
                                 int(rng.lognormvariate(mu, self.len_sigma))))

    def generate(self, salt: str = "") -> tuple[Request, ...]:
        """The pattern's request stream, sorted by arrival.  Deterministic
        in ``(seed, name, salt)``; independent of process and platform."""
        if self.kind not in ("poisson", "bursty", "diurnal"):
            raise ValueError(f"unknown traffic kind {self.kind!r}")
        rng = random.Random(_mix_seed(self.seed, f"{self.name}:{salt}"))
        out = []
        t = 0.0
        bursting = True             # bursty chain starts hot
        for rid in range(self.n_requests):
            if self.kind == "poisson":
                rate = self.rate_rps
            elif self.kind == "bursty":
                if rng.random() < self.switch_prob:
                    bursting = not bursting
                rate = self.rate_rps * (self.burst_factor if bursting
                                        else self.idle_factor)
            else:
                rate = self._rate_at(t)
            t += rng.expovariate(rate)
            out.append(Request(
                rid=rid,
                arrival_s=t,
                prompt_len=self._length(rng, self.prompt_mean,
                                        self.prompt_clamp),
                gen_len=self._length(rng, self.gen_mean, self.gen_clamp),
            ))
        return tuple(out)


# -- pattern registry -----------------------------------------------------------
# The named patterns table_serving sweeps, plus a short smoke trace for the
# CI serving step and the examples (same shapes, a fraction of the load).
PATTERNS: dict[str, TrafficPattern] = {
    p.name: p for p in (
        TrafficPattern("poisson", kind="poisson", seed=11),
        TrafficPattern("bursty", kind="bursty", seed=22),
        TrafficPattern("diurnal", kind="diurnal", seed=33),
        TrafficPattern("poisson_short", kind="poisson", seed=44,
                       n_requests=12, rate_rps=8.0,
                       prompt_mean=768, gen_mean=48),
    )
}


def get_pattern(name_or_pattern) -> TrafficPattern:
    """Resolve a pattern name through the registry (pass-through for
    :class:`TrafficPattern` objects); ``serve_``-prefixed cell app labels
    are accepted and stripped."""
    if isinstance(name_or_pattern, TrafficPattern):
        return name_or_pattern
    name = str(name_or_pattern)
    if name.startswith("serve_"):
        name = name[len("serve_"):]
    try:
        return PATTERNS[name]
    except KeyError:
        raise KeyError(f"unknown traffic pattern {name_or_pattern!r}; "
                       f"registered: {pattern_names()}") from None


def pattern_names() -> tuple[str, ...]:
    return tuple(PATTERNS)
