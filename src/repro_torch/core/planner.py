"""Queue-aware channel planner: COAXIAL's trade on H100 cards over NVLink.

Port of ``repro/core/planner.py``.  The paper's transferable claim:

    In a loaded memory system, effective access time = service + queuing;
    queuing dominates; spreading traffic over N channels at a fixed
    interface-latency premium reduces both the mean and the variance of
    access time -- so trade unloaded latency for channel parallelism
    whenever the system is loaded.

On the card the local channel is one H100's HBM; the added channels are
the HBM of more H100s reached over NVLink (more aggregate bandwidth, plus
a fixed latency a stage of the combine).  The planner weighs that trade
for the bandwidth-hot state of serving and training, on a
``hw.GpuSpec`` (``H100_SXM`` by default: its HBM rate and size, its bf16
peak, and its links' one-way bandwidth and hop latency):

  * :func:`plan_decode_kv` -- split a KV cache over n cards by sequence;
    each card streams 1/n of the KV bytes from its own HBM, and the
    partial attention outputs meet in a flash-decode merge (the running
    max, sum and weighted values of each part), log2(n) stages over
    NVLink;
  * :func:`plan_param_channels` -- weights replicated on every card vs
    sharded over n cards and all-gathered over NVLink (FSDP);
  * :func:`asym_schedule` -- split the overlap window of a step between
    read-like (all-gather) and write-like (reduce-scatter) traffic by the
    step's R:W byte ratio, the paper's §4.3 CXL-asym idea for duplex
    links.

Where several streams share one HBM, the memory time is inflated by an
M/G/1-style contention factor (the paper's Fig 2a).  All of it is scalar
Python arithmetic: nothing here runs on the card.  :func:`roofline_terms`
(on its own :class:`RooflineSpec`) serves the serving demand model.
"""

from __future__ import annotations

import dataclasses
import math

from repro_torch.core.hw import H100_SXM, GpuSpec

#: Burstiness of DMA traffic within a step (weights/activations/KV phases
#: overlap imperfectly); mild compared to CPU-world kappa.
DMA_KAPPA = 1.15


@dataclasses.dataclass(frozen=True)
class StepCost:
    """Roofline-style cost of one step under a candidate sharding."""

    name: str
    compute_s: float
    hbm_s: float
    link_s: float
    hop_lat_s: float

    @property
    def total_s(self) -> float:
        """Bound on step time: overlappable terms take their max; the hop
        latency is serial (it gates the combine)."""
        return max(self.compute_s, self.hbm_s, self.link_s) + self.hop_lat_s

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.hbm_s,
                 "collective": self.link_s + self.hop_lat_s}
        return max(terms, key=terms.get)


def contention_factor(rho: float, kappa: float = DMA_KAPPA) -> float:
    """M/G/1-style inflation of memory time when the HBM channel is loaded.

    Same shape as the reproduction's queue model: at utilization rho the
    effective service time is inflated by 1 + kappa^2 * rho / (2*(1-rho)).
    """
    rho = min(max(rho, 0.0), 0.97)
    return 1.0 + kappa**2 * rho / (2.0 * (1.0 - rho))


def effective_hbm_time(bytes_per_card: float, spec: GpuSpec = H100_SXM,
                       background_rho: float = 0.0) -> float:
    """Seconds to stream ``bytes_per_card`` from HBM under contention."""
    base = bytes_per_card / spec.hbm_bw
    return base * contention_factor(background_rho)


# ---------------------------------------------------------------------------
# Channelized KV-cache decode (the paper's §4 trade, over NVLink).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodePlan:
    n_channels: int              # sequence shards of the KV cache (cards)
    cost: StepCost
    baseline: StepCost           # n = 1 (all KV in one card's HBM)

    @property
    def speedup(self) -> float:
        return self.baseline.total_s / self.cost.total_s


def decode_step_cost(*, kv_bytes: float, qkv_flops: float,
                     combine_bytes: float, n: int,
                     spec: GpuSpec = H100_SXM,
                     background_rho: float = 0.0) -> StepCost:
    """Cost of one decode step with the KV cache spread over n cards.

    kv_bytes      total KV bytes read per step (all layers);
    qkv_flops     attention flops per step (scales 1/n per card);
    combine_bytes bytes exchanged to merge partial attention outputs
                  (per merge stage; log2(n) tree stages).
    """
    stages = math.ceil(math.log2(n)) if n > 1 else 0
    hbm = effective_hbm_time(kv_bytes / n, spec, background_rho)
    link = stages * combine_bytes / spec.link_bw if n > 1 else 0.0
    hop = stages * spec.nvlink_hop_s
    return StepCost(name=f"kv-channels={n}", compute_s=qkv_flops / n /
                    spec.peak_bf16_flops, hbm_s=hbm, link_s=link,
                    hop_lat_s=hop)


def plan_decode_kv(*, kv_bytes: float, qkv_flops: float,
                   combine_bytes: float, max_channels: int = 16,
                   spec: GpuSpec = H100_SXM,
                   background_rho: float = 0.0) -> DecodePlan:
    """Pick the KV channel count minimizing decode step time.

    This is COAXIAL's Fig 2a argument verbatim: more channels cut the
    memory term ~1/n while adding a fixed per-stage latency premium; the
    optimum moves to larger n exactly when the memory system is loaded
    (large kv_bytes or high background utilization).
    """
    candidates = [1]
    while candidates[-1] * 2 <= max_channels:
        candidates.append(candidates[-1] * 2)
    costs = [decode_step_cost(kv_bytes=kv_bytes, qkv_flops=qkv_flops,
                              combine_bytes=combine_bytes, n=n, spec=spec,
                              background_rho=background_rho)
             for n in candidates]
    best = min(range(len(costs)), key=lambda i: costs[i].total_s)
    return DecodePlan(n_channels=candidates[best], cost=costs[best],
                      baseline=costs[0])


# ---------------------------------------------------------------------------
# Training-side: FSDP parameter channels.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamPlan:
    shards: int
    cost: StepCost
    baseline: StepCost

    @property
    def speedup(self) -> float:
        return self.baseline.total_s / self.cost.total_s


def plan_param_channels(*, param_bytes: float, step_flops_per_chip: float,
                        layers: int, shard_candidates=(1, 2, 4, 8, 16),
                        state_bytes_factor: float = 7.0,
                        hbm_budget_bytes: float | None = None,
                        spec: GpuSpec = H100_SXM) -> ParamPlan:
    """Replicated weights (1 channel) vs FSDP-sharded over n cards.

    Replicated: every card streams the full param_bytes from its HBM each
    step.  Sharded over n: each card stores 1/n, and an all-gather streams
    the same bytes over NVLink (overlapped per layer).

    Unlike the KV-cache case, *every* card consumes every parameter, so
    channelizing cannot multiply the usable bandwidth: one H100's NVLink
    (450 GB/s one way) is slower than its HBM (3.35 TB/s), and replication
    wins on pure time.  FSDP is a CAPACITY play: a candidate is infeasible
    when its resident bytes (params + optimizer states,
    ``state_bytes_factor`` x params in fp32 master/mu/nu terms) exceed the
    HBM budget.  The COAXIAL bandwidth argument applies to state that
    *stays local after sharding* (KV, experts), not to broadcast-consumed
    state.
    """
    budget = hbm_budget_bytes if hbm_budget_bytes is not None \
        else 0.8 * spec.hbm_bytes
    costs = []
    feasible = []
    for n in shard_candidates:
        resident = param_bytes * (1.0 + state_bytes_factor) / n
        if n == 1:
            hbm = effective_hbm_time(param_bytes, spec)
            c = StepCost("replicated", step_flops_per_chip /
                         spec.peak_bf16_flops, hbm, 0.0, 0.0)
        else:
            hbm = effective_hbm_time(param_bytes / n, spec)
            link = param_bytes * (n - 1) / n / spec.link_bw
            hop = layers * spec.nvlink_hop_s
            c = StepCost(f"fsdp={n}", step_flops_per_chip /
                         spec.peak_bf16_flops, hbm, link, hop)
        costs.append(c)
        feasible.append(resident <= budget)
    idx = [i for i in range(len(costs)) if feasible[i]]
    if not idx:
        idx = [len(costs) - 1]      # largest sharding is the last resort
    best = min(idx, key=lambda i: costs[i].total_s)
    return ParamPlan(shards=shard_candidates[best], cost=costs[best],
                     baseline=costs[0])


# ---------------------------------------------------------------------------
# Asymmetric collective schedule (CXL-asym, §4.3, for duplex links).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AsymSchedule:
    read_fraction: float        # share of overlap window given to all-gather
    write_fraction: float       # share given to reduce-scatter
    read_bytes: float
    write_bytes: float

    @property
    def rw_ratio(self) -> float:
        return self.read_bytes / max(self.write_bytes, 1.0)


def asym_schedule(read_bytes: float, write_bytes: float) -> AsymSchedule:
    """Split the duplex-link overlap budget by the step's R:W byte ratio.

    PCIe mandates 1:1 RX/TX lanes; the paper shows memory traffic is 2:1 to
    3:1 R:W and gains 15% from asymmetric provisioning.  NVLink is duplex,
    but the *scheduling window* (how early the next layer's parameter
    all-gather is prefetched vs how late the gradient reduce-scatter is
    drained) is the software analogue: the overlap budget goes to each
    in proportion to its bytes instead of 1:1.
    """
    total = read_bytes + write_bytes
    if total <= 0:
        return AsymSchedule(0.5, 0.5, read_bytes, write_bytes)
    rf = read_bytes / total
    return AsymSchedule(read_fraction=rf, write_fraction=1.0 - rf,
                        read_bytes=read_bytes, write_bytes=write_bytes)


# ---------------------------------------------------------------------------
# Roofline terms (the serving demand model's).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RooflineSpec:
    """What :func:`roofline_terms` reads of a machine."""

    #: Peak arithmetic rate, FLOP/s.
    peak_flops: float
    #: Memory bandwidth, bytes/s.
    hbm_bw: float
    #: Bandwidth of one link for collective traffic, bytes/s.
    link_bw: float


def roofline_terms(*, hlo_flops: float, hlo_bytes: float,
                   collective_bytes: float, chips: int,
                   spec: RooflineSpec) -> dict:
    """The three roofline terms of a whole step on ``chips`` machines of
    ``spec``, in seconds, with the ``dominant`` one and their max
    (``bound_s``)."""
    compute_s = hlo_flops / (chips * spec.peak_flops)
    memory_s = hlo_bytes / (chips * spec.hbm_bw)
    collective_s = collective_bytes / (chips * spec.link_bw)
    terms = dict(compute_s=compute_s, memory_s=memory_s,
                 collective_s=collective_s)
    terms["dominant"] = max(("compute_s", "memory_s", "collective_s"),
                            key=lambda k: terms[k])
    terms["bound_s"] = max(compute_s, memory_s, collective_s)
    return terms
