"""Wire-level fault plans for the apiserver (``ApiServerProxy``).

The port's copy of ``kubeflow_tpu/cluster/faults.py``. A ``FaultPlan``
handed to the apiserver makes it misbehave the way a stressed or
partitioned kube-apiserver does:

- ``429 Too Many Requests`` with a ``Retry-After`` header;
- ``500``/``503`` Status responses;
- a connection reset mid-body (the mutation applied, the client cannot
  know: the ambiguous failure);
- watch-stream kills after a set lifetime;
- latency spikes.

Faults are decided per request from a seeded RNG, so a plan and a seed
replay the same fault sequence for the same arrival order. Rules match
on verb and kind; matching rules compose cumulatively on one draw. Every
injected fault is counted per (fault, verb).
"""

from __future__ import annotations

import random
import threading
from dataclasses import dataclass, field

#: the wire verbs a rule can match (client-go's request verbs; ``watch``
#: is a GET with ``?watch=true``, ``list`` a GET without a resource name)
VERBS = frozenset({"get", "list", "create", "update", "patch", "delete",
                   "watch"})
#: mutation verbs — what the uniform() convenience keeps reset faults on
MUTATING_VERBS = frozenset({"create", "update", "patch", "delete"})

FAULT_HTTP = "http"            # a Status error response (429/500/503/…)
FAULT_RESET = "reset"          # connection reset mid-body
FAULT_LATENCY = "latency"      # added per-request latency
FAULT_WATCH_KILL = "watch_kill"  # kill the watch stream after after_s
FAULTS = frozenset({FAULT_HTTP, FAULT_RESET, FAULT_LATENCY,
                    FAULT_WATCH_KILL})

_REASON_BY_STATUS = {429: "TooManyRequests", 500: "InternalError",
                     503: "ServiceUnavailable"}


@dataclass(frozen=True)
class FaultRule:
    """One match-and-inject rule. ``verbs``/``kinds`` of ``None`` match
    everything (watch_kill rules only ever fire on the watch verb)."""

    fault: str                        # one of FAULTS
    rate: float                       # probability in [0, 1]
    verbs: frozenset[str] | None = None
    kinds: frozenset[str] | None = None
    status: int = 503                 # FAULT_HTTP: the wire status
    retry_after_s: float | None = None  # FAULT_HTTP: Retry-After header
    latency_s: float = 0.0            # FAULT_LATENCY: added delay
    after_s: float = 0.0              # FAULT_WATCH_KILL: stream lifetime
    times: int | None = None          # fire at most N times (None = ∞) —
    #                                   deterministic burst scripting
    #                                   ("first 3 requests 429, then heal")

    def __post_init__(self) -> None:
        if self.fault not in FAULTS:
            raise ValueError(f"unknown fault {self.fault!r}; "
                             f"expected one of {sorted(FAULTS)}")
        if self.verbs is not None:
            unknown = set(self.verbs) - VERBS
            if unknown:
                raise ValueError(f"unknown verbs {sorted(unknown)}; "
                                 f"expected a subset of {sorted(VERBS)}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")

    @property
    def reason(self) -> str:
        return _REASON_BY_STATUS.get(self.status, "InjectedFault")

    def matches(self, verb: str, kind: str | None) -> bool:
        if self.fault == FAULT_WATCH_KILL and verb != "watch":
            return False
        if self.verbs is not None and verb not in self.verbs:
            return False
        if self.kinds is not None and (kind is None or
                                       kind not in self.kinds):
            return False
        return True


@dataclass
class FaultPlan:
    """An ordered rule set + seeded RNG. Thread-safe: the apiserver decides
    faults from many handler threads; injected-fault counters and the RNG
    share one lock so a seeded run stays replayable under the ThreadingHTTPServer
    (per-request ordering still depends on arrival order, as on a real wire).
    """

    rules: list[FaultRule] = field(default_factory=list)
    seed: int | None = None
    active: bool = True

    def __post_init__(self) -> None:
        self._rng = random.Random(self.seed)
        self._lock = threading.Lock()
        self._injected: dict[tuple[str, str], int] = {}
        self._fired_per_rule: dict[int, int] = {}

    # ------------------------------------------------------------- control
    def deactivate(self) -> None:
        """The chaos suite's Deactivate(): stop injecting, keep counters."""
        self.active = False

    def activate(self) -> None:
        self.active = True

    # -------------------------------------------------------------- decide
    def decide(self, verb: str, kind: str | None = None) -> FaultRule | None:
        """The rule that fires for this request, else None. Matching rules
        compose CUMULATIVELY on one draw: a request's total fault
        probability is the sum of its matching rules' rates (capped at 1),
        so a plan that splits rate R across three fault shapes injects at
        exactly R — independent per-rule draws would compound to less."""
        if not self.active or not self.rules:
            return None
        with self._lock:
            matching = []
            for i, rule in enumerate(self.rules):
                if rule.times is not None and \
                        self._fired_per_rule.get(i, 0) >= rule.times:
                    continue  # burst budget spent
                if rule.matches(verb, kind) and rule.rate > 0:
                    matching.append((i, rule))
            if not matching:
                return None
            draw = self._rng.random()
            cumulative = 0.0
            for i, rule in matching:
                cumulative += rule.rate
                if draw < cumulative:
                    key = (rule.fault, verb)
                    self._injected[key] = self._injected.get(key, 0) + 1
                    self._fired_per_rule[i] = \
                        self._fired_per_rule.get(i, 0) + 1
                    return rule
        return None

    def injected(self) -> dict[tuple[str, str], int]:
        """Counts of injected faults by (fault, verb) — soaks assert the
        plan actually fired; zero injections would vacuously 'pass'."""
        with self._lock:
            return dict(self._injected)

    def injected_total(self) -> int:
        with self._lock:
            return sum(self._injected.values())

    # -------------------------------------------------------- constructors
    @classmethod
    def uniform(cls, rate: float, seed: int | None = None, *,
                kinds: frozenset[str] | None = None,
                retry_after_s: float = 0.05,
                watch_kill_after_s: float = 1.0,
                latency_spike_s: float = 0.0) -> "FaultPlan":
        """The standard mixed plan the soaks use: ``rate`` per verb
        (decide() composes matching rules cumulatively, so each verb's
        total IS ``rate``), split evenly across 429-with-Retry-After,
        503, and connection reset — reset kept on mutating verbs, where
        the ambiguity actually bites; reads take that share as extra
        503s — plus watch-stream kills at ``rate`` and an optional
        latency spike."""
        third = rate / 3.0
        rest_verbs = VERBS - {"watch"}       # REST verbs total exactly rate
        read_verbs = rest_verbs - MUTATING_VERBS
        rules = [
            FaultRule(FAULT_HTTP, third, status=429, verbs=rest_verbs,
                      retry_after_s=retry_after_s, kinds=kinds),
            FaultRule(FAULT_HTTP, third, status=503, verbs=rest_verbs,
                      kinds=kinds),
            FaultRule(FAULT_RESET, third, verbs=MUTATING_VERBS, kinds=kinds),
            FaultRule(FAULT_HTTP, third, status=503, verbs=read_verbs,
                      kinds=kinds),
            FaultRule(FAULT_WATCH_KILL, rate, after_s=watch_kill_after_s,
                      kinds=kinds),
        ]
        if latency_spike_s > 0:
            rules.append(FaultRule(FAULT_LATENCY, rate,
                                   latency_s=latency_spike_s, kinds=kinds))
        return cls(rules=rules, seed=seed)

    @classmethod
    def outage(cls, seed: int | None = None) -> "FaultPlan":
        """Total outage: every request (watch connects included) is reset.
        The wire analog of stopping the apiserver without losing the
        listening socket — what trips the manager's circuit breaker."""
        return cls(rules=[FaultRule(FAULT_RESET, 1.0)], seed=seed)

    @classmethod
    def from_dict(cls, doc: dict) -> "FaultPlan":
        """Build from a YAML/JSON document::

            seed: 7
            rules:
              - fault: http
                rate: 0.05
                status: 429
                retryAfterS: 0.1
                verbs: [get, list]
                kinds: [Notebook]
              - fault: watch_kill
                rate: 0.1
                afterS: 2.0
        """
        rules = []
        for raw in doc.get("rules", []):
            rules.append(FaultRule(
                fault=raw["fault"],
                rate=float(raw["rate"]),
                verbs=frozenset(raw["verbs"]) if raw.get("verbs") else None,
                kinds=frozenset(raw["kinds"]) if raw.get("kinds") else None,
                status=int(raw.get("status", 503)),
                retry_after_s=(float(raw["retryAfterS"])
                               if raw.get("retryAfterS") is not None else None),
                latency_s=float(raw.get("latencyS", 0.0)),
                after_s=float(raw.get("afterS", 0.0)),
                times=(int(raw["times"])
                       if raw.get("times") is not None else None),
            ))
        return cls(rules=rules, seed=doc.get("seed"))

    @classmethod
    def from_file(cls, path) -> "FaultPlan":
        import yaml
        from pathlib import Path
        doc = yaml.safe_load(Path(path).read_text()) or {}
        return cls.from_dict(doc)
