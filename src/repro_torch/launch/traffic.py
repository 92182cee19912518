"""Deterministic serving traffic: seeded request streams + an analytic
continuous-batching simulator.

Serving quality is a property of an architecture *under load*: p99
latency depends on the arrival process, the prompt/generation length
mix, and how the engine batches — not just on single-request kernel
time.  :class:`TrafficSpec` declares that load as part of the experiment
(validated YAML, fixed seed, bit-identical replay on every backend);
:class:`ServingSim` is the discrete-event model of the serving engine
in :mod:`repro_torch.launch.serve` — bounded admission queue, continuous
batching up to a concurrency limit, shedding when the queue is full —
driven by modelled (roofline) step costs, so it is deterministic and
never reads a wall clock.

This is the port's own copy of the JAX package's numpy-only module: the
same spec and seed give the same request stream in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np

ARRIVALS = ("poisson", "uniform", "burst")


class TrafficError(ValueError):
    pass


def _require_mapping(raw: Any, where: str) -> Dict[str, Any]:
    if not isinstance(raw, Mapping):
        raise TrafficError(f"{where}: expected a mapping, got {type(raw).__name__}")
    return dict(raw)


def _length_mix(raw: Any, where: str, default_len: int) -> Dict[int, float]:
    """``{length: weight}`` mapping; a bare int or list are shorthand."""
    if raw is None:
        return {default_len: 1.0}
    if isinstance(raw, int):
        raw = {raw: 1.0}
    if isinstance(raw, (list, tuple)):
        raw = {v: 1.0 for v in raw}
    raw = _require_mapping(raw, where)
    mix: Dict[int, float] = {}
    for k, w in raw.items():
        try:
            length = int(k)
        except (TypeError, ValueError):
            raise TrafficError(f"{where}: length {k!r} is not an integer") from None
        if length < 1:
            raise TrafficError(f"{where}: length must be >= 1, got {length}")
        weight = float(w)
        if weight <= 0:
            raise TrafficError(f"{where}: weight for {length} must be > 0, got {w}")
        mix[length] = weight
    if not mix:
        raise TrafficError(f"{where}: needs at least one length: weight entry")
    total = sum(mix.values())
    return {k: v / total for k, v in sorted(mix.items())}


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request of the seeded stream."""

    id: int
    arrival_s: float
    prompt_len: int
    gen_len: int
    token_seed: int  # per-request seed for synthetic prompt tokens

    def prompt_tokens(self, vocab: int) -> np.ndarray:
        rng = np.random.default_rng(self.token_seed)
        return rng.integers(0, vocab, self.prompt_len).astype(np.int32)


@dataclasses.dataclass
class TrafficSpec:
    """A declared, seeded traffic mix — replays bit-identically."""

    seed: int = 0
    n_requests: int = 32
    rate_rps: float = 8.0
    arrival: str = "poisson"
    prompt_lens: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {32: 1.0})
    gen_lens: Dict[int, float] = dataclasses.field(
        default_factory=lambda: {32: 1.0})

    KEYS = ("seed", "n_requests", "rate_rps", "arrival", "prompt_lens",
            "gen_lens")
    FIELD_DOCS = {
        "seed": "seed for the request stream RNG — the same seed replays "
                "the exact same arrivals, lengths, and prompt tokens on "
                "every backend (default 0)",
        "n_requests": "number of requests in the stream (integer >= 1, "
                      "default 32)",
        "rate_rps": "mean arrival rate in requests/second (> 0, default "
                    "8.0); ignored by `arrival: burst`",
        "arrival": "`poisson` (default) — exponential interarrivals | "
                   "`uniform` — evenly spaced at `1/rate_rps` | `burst` — "
                   "all requests arrive at t=0",
        "prompt_lens": "prompt-length mix as a `{length: weight}` mapping "
                       "(weights normalize); a bare integer or a list "
                       "(equal weights) are shorthand (default `{32: 1}`)",
        "gen_lens": "generation-length mix, same shape as `prompt_lens` "
                    "(default `{32: 1}`)",
    }

    @classmethod
    def from_raw(cls, raw: Any, where: str = "traffic") -> "TrafficSpec":
        if raw is None:
            return cls()
        raw = _require_mapping(raw, where)
        unknown = set(raw) - set(cls.KEYS)
        if unknown:
            raise TrafficError(
                f"{where}: unknown key(s) {sorted(unknown)}; expected a "
                f"subset of {cls.KEYS}")
        n = int(raw.get("n_requests", 32))
        if n < 1:
            raise TrafficError(f"{where}: n_requests must be >= 1, got {n}")
        rate = float(raw.get("rate_rps", 8.0))
        if rate <= 0:
            raise TrafficError(f"{where}: rate_rps must be > 0, got {rate}")
        arrival = str(raw.get("arrival", "poisson"))
        if arrival not in ARRIVALS:
            raise TrafficError(
                f"{where}: unknown arrival {arrival!r}; expected one of "
                f"{ARRIVALS}")
        return cls(
            seed=int(raw.get("seed", 0)),
            n_requests=n,
            rate_rps=rate,
            arrival=arrival,
            prompt_lens=_length_mix(raw.get("prompt_lens"),
                                    f"{where}.prompt_lens", 32),
            gen_lens=_length_mix(raw.get("gen_lens"),
                                 f"{where}.gen_lens", 32),
        )

    def to_dict(self) -> Dict[str, Any]:
        return {
            "seed": self.seed,
            "n_requests": self.n_requests,
            "rate_rps": self.rate_rps,
            "arrival": self.arrival,
            "prompt_lens": {int(k): float(v) for k, v in self.prompt_lens.items()},
            "gen_lens": {int(k): float(v) for k, v in self.gen_lens.items()},
        }

    # -- stream generation --------------------------------------------------

    def requests(self) -> List[Request]:
        """The seeded request stream, sorted by arrival time.  Pure
        function of the spec: same spec -> bit-identical stream."""
        rng = np.random.default_rng(self.seed)
        n = self.n_requests
        if self.arrival == "burst":
            arrivals = np.zeros(n)
        elif self.arrival == "uniform":
            arrivals = np.arange(n) / self.rate_rps
        else:  # poisson
            arrivals = np.cumsum(rng.exponential(1.0 / self.rate_rps, n))
        p_lens = np.array(sorted(self.prompt_lens), dtype=np.int64)
        p_w = np.array([self.prompt_lens[int(k)] for k in p_lens])
        g_lens = np.array(sorted(self.gen_lens), dtype=np.int64)
        g_w = np.array([self.gen_lens[int(k)] for k in g_lens])
        prompt = rng.choice(p_lens, size=n, p=p_w)
        gen = rng.choice(g_lens, size=n, p=g_w)
        seeds = rng.integers(0, 2**31 - 1, n)
        return [
            Request(id=i, arrival_s=float(arrivals[i]),
                    prompt_len=int(prompt[i]), gen_len=int(gen[i]),
                    token_seed=int(seeds[i]))
            for i in range(n)
        ]

    @property
    def max_context(self) -> int:
        """Longest prompt+generation any request of this mix can need."""
        return max(self.prompt_lens) + max(self.gen_lens)


@dataclasses.dataclass
class ServingCosts:
    """Modelled engine step costs (seconds).  ``prefill_s_per_token`` is
    paid once per prompt token when a request joins the batch;
    ``decode_step_s`` is paid per engine iteration that advances the
    whole active batch by one token."""

    prefill_s_per_token: float
    decode_step_s: float


class ServingSim:
    """Discrete-event model of the continuous-batching serving engine.

    Mirrors :class:`repro_torch.launch.serve.ServingEngine` decision-for-
    decision — bounded admission queue (arrivals shed when it is full),
    slots filled from the queue up to ``max_batch``, joining requests
    paying prefill before the batch resumes decoding — but advances a
    simulated clock by modelled costs, so its summary is a deterministic
    pure function of (requests, costs).
    """

    def __init__(self, max_batch: int, queue_limit: int):
        if max_batch < 1:
            raise TrafficError(f"max_batch must be >= 1, got {max_batch}")
        if queue_limit < 1:
            raise TrafficError(f"queue_limit must be >= 1, got {queue_limit}")
        self.max_batch = int(max_batch)
        self.queue_limit = int(queue_limit)

    def run(self, requests: List[Request], costs: ServingCosts) -> Dict[str, Any]:
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.id))
        queue: List[Request] = []
        active: List[List[Any]] = []  # [request, tokens_done]
        now = 0.0
        shed: List[int] = []
        latencies: List[float] = []
        served = 0
        total_tokens = 0
        kv_peak_tokens = 0
        peak_active = 0

        def admit(upto: float):
            nonlocal pending
            while pending and pending[0].arrival_s <= upto:
                r = pending.pop(0)
                if len(queue) >= self.queue_limit:
                    shed.append(r.id)
                else:
                    queue.append(r)

        while pending or queue or active:
            admit(now)
            if not queue and not active:
                # idle: jump to the next arrival
                now = max(now, pending[0].arrival_s)
                admit(now)
            # fill free slots; joiners pay prefill before decode resumes
            while queue and len(active) < self.max_batch:
                r = queue.pop(0)
                now += r.prompt_len * costs.prefill_s_per_token
                active.append([r, 0])
            peak_active = max(peak_active, len(active))
            kv_now = sum(r.prompt_len + done for r, done in active)
            kv_peak_tokens = max(kv_peak_tokens, kv_now)
            if not active:
                continue
            # one engine iteration: every active slot decodes one token
            now += costs.decode_step_s
            total_tokens += len(active)
            still = []
            for slot in active:
                slot[1] += 1
                if slot[1] >= slot[0].gen_len:
                    latencies.append(now - slot[0].arrival_s)
                    served += 1
                else:
                    still.append(slot)
            active = still

        latencies.sort()
        return {
            "served": served,
            "shed": len(shed),
            "shed_ids": shed,
            "total_tokens": total_tokens,
            "makespan_s": now,
            "throughput_tok_s": total_tokens / now if now > 0 else 0.0,
            "p50_latency_s": _quantile(latencies, 0.50),
            "p99_latency_s": _quantile(latencies, 0.99),
            "peak_concurrency": peak_active,
            "kv_peak_tokens": kv_peak_tokens,
        }


def _quantile(sorted_values: List[float], q: float) -> float:
    """Nearest-rank quantile — exact, no interpolation, deterministic."""
    if not sorted_values:
        return 0.0
    n = len(sorted_values)
    rank = max(1, int(np.ceil(q * n)))
    return float(sorted_values[min(rank, n) - 1])
