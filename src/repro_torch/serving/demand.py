"""Per-decode-step memory demand of a model config, as a ``Workload``.

Port of ``repro/serving/demand.py``; pure Python arithmetic, as the
reference's, so its numbers are the reference's to the bit.

LLM decode is the throughput-server workload of the paper's argument: a
batch of sequences each reads its whole KV cache (or recurrent state)
plus its share of the streamed weights for every generated token.  This
module turns a :class:`repro_torch.models.config.ModelConfig` at a
given (batch, context) operating point into the same (ipc, mpki, wb,
exec_frac, ws_mb) vector Table 4 gives for the paper's 35 workloads, so
every sweep axis, figure, and drift row of the evaluator works on LLM
workloads unchanged.

The derivation has two halves:

* **Bytes and flops per token** are exact arithmetic on the config:
  family-aware state reads (GQA KV for attention archs, SSD/RWKV state
  for recurrent ones, both for hybrids), weight streaming amortized over
  the batch, and the matching flop count.  This mirrors what
  ``kernels/decode_attn`` actually moves per step.

* **(ipc, exec_frac)** come from the planner's roofline math evaluated
  on the paper's *baseline* machine (12 cores @ 2 GHz, one DDR5-4800
  channel) -- Table 4's IPC column is defined on that machine, so the
  derived workloads must anchor the CPU model the same way.  Roofline
  terms: ``compute_s`` at the socket's SIMD peak, ``memory_s`` at the
  single channel's bandwidth, derated by :data:`MEM_QUEUE_DERATE` for
  queuing + latency above the pure-bandwidth floor.  The derate is fitted
  so the mapping reproduces the paper's own streaming rows when fed
  STREAM-like demand: stream-copy's (mpki 58, wb 0.4) maps to ipc 0.18
  vs Table 4's 0.17, lbm's (64, 0.5) to 0.15 vs 0.14.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core import hw
from repro_torch.core.planner import RooflineSpec, roofline_terms
from repro_torch.core.workloads import (Workload, by_name, register_workload,
                                        unregister_workload)
from repro_torch.models.config import ModelConfig

#: Useful flops retired per instruction on the baseline cores (SIMD FMA
#: streams; the same granularity Table 4's MPKI denominators imply).
FLOPS_PER_INST = 8.0
#: Peak SIMD flops per core-cycle (2 FMA ports x 8 bf16 lanes x 2).
CORE_FLOPS_PER_CYCLE = 32.0
#: Queuing + exposed-latency derate of the single-channel baseline's
#: memory time over the pure-bandwidth roofline term (fit to Table 4's
#: STREAM/lbm rows, see module docstring).
MEM_QUEUE_DERATE = 0.6
#: Suite tag for derived LLM workloads.
LLM_SUITE = "llm"

#: Default operating point: the decode_32k serving shape.
DEFAULT_BATCH = 128
DEFAULT_CONTEXT = 32768

#: The paper's baseline machine, phrased as a roofline spec: socket SIMD
#: peak and ONE DDR5-4800 channel (Table 4's measurement machine).  The
#: collective term never fires (no inter-socket traffic in decode).
BASELINE_SPEC = RooflineSpec(
    peak_flops=hw.SIM_CORES * CORE_FLOPS_PER_CYCLE * hw.CORE_CLK_GHZ * 1e9,
    hbm_bw=hw.DDR5_CH_BW_GBPS * 1e9, link_bw=1e30)

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4, "int8": 1}


def _dtype_bytes(dtype: str) -> int:
    return _DTYPE_BYTES.get(dtype, 2)


@dataclasses.dataclass(frozen=True)
class DecodeDemand:
    """Memory behavior of one decode step at a fixed operating point.

    Per-token quantities are per generated token of ONE sequence; the
    batch enters only through weight amortization (weights are read once
    per step and shared by all ``batch`` tokens) and the working set.
    """

    arch: str
    family: str
    batch: int
    context: int
    state_read_bytes: float    # KV/recurrent state read per token
    state_write_bytes: float   # KV append / state rewrite per token
    weight_bytes: float        # amortized weight stream per token
    flops_per_token: float
    inst_per_token: float
    compute_s: float           # roofline terms for one whole step
    memory_s: float            # (batch tokens) on the DDR baseline
    mpki: float
    wb: float
    ipc: float
    exec_frac: float
    ws_mb: float

    @property
    def read_bytes(self) -> float:
        """Total bytes read per generated token."""
        return self.state_read_bytes + self.weight_bytes

    @property
    def dominant(self) -> str:
        return "compute" if self.compute_s > self.memory_s else "memory"


def _state_bytes(cfg: ModelConfig, context: int) -> tuple[float, float]:
    """(read, write) state bytes per generated token of one sequence."""
    b = _dtype_bytes(cfg.dtype)
    hd = cfg.resolved_head_dim
    ctx = min(context, cfg.sliding_window) if cfg.sliding_window else context
    read = write = 0.0
    if cfg.family in ("dense", "vlm", "moe", "audio"):
        n_attn = cfg.n_layers
    elif cfg.family == "hybrid":
        n_attn = max(cfg.n_layers // max(cfg.attn_every, 1), 1)
    else:
        n_attn = 0
    if cfg.encoder_only:
        n_attn = 0          # no KV cache; every frame is recomputed
    if n_attn:
        # K and V for every cached position, every attention layer ...
        read += 2.0 * n_attn * cfg.n_kv_heads * hd * ctx * b
        # ... plus appending this token's slot.
        write += 2.0 * n_attn * cfg.n_kv_heads * hd * b
    if cfg.family == "hybrid":
        # SSD recurrence: the full (heads x P x N) state is read and
        # rewritten every token, in every mamba layer.
        ssd = cfg.n_layers * cfg.d_inner * cfg.ssm_state * b
        read += ssd
        write += ssd
    if cfg.family == "ssm":
        # RWKV6 time-mix state (heads x D x D) + channel-mix shift.
        st = cfg.n_layers * (cfg.d_model * cfg.rwkv_head_dim +
                             2 * cfg.d_model) * b
        read += st
        write += st
    return read, write


def _flops_per_token(cfg: ModelConfig, context: int) -> float:
    ctx = min(context, cfg.sliding_window) if cfg.sliding_window else context
    hd = cfg.resolved_head_dim
    flops = 2.0 * cfg.active_param_count()
    if cfg.family in ("dense", "vlm", "moe", "audio") and not cfg.encoder_only:
        flops += 4.0 * cfg.n_layers * cfg.n_heads * hd * ctx
    elif cfg.family == "hybrid":
        n_attn = max(cfg.n_layers // max(cfg.attn_every, 1), 1)
        flops += 4.0 * n_attn * cfg.n_heads * hd * ctx
        flops += 4.0 * cfg.n_layers * cfg.d_inner * cfg.ssm_state
    elif cfg.family == "ssm":
        flops += 4.0 * cfg.n_layers * cfg.d_model * cfg.rwkv_head_dim
    return flops


def decode_demand(cfg: ModelConfig | str, *, batch: int = DEFAULT_BATCH,
                  context: int = DEFAULT_CONTEXT) -> DecodeDemand:
    """Derive one decode step's memory behavior at (batch, context).

    Accepts a :class:`ModelConfig` or an arch id from
    ``repro_torch.configs``.
    Encoder-only configs have no KV cache; their demand is the weight
    stream alone (still finite and positive).
    """
    if isinstance(cfg, str):
        from repro_torch.configs import get_config
        cfg = get_config(cfg)
    if batch < 1 or context < 1:
        raise ValueError("batch and context must be >= 1")
    b = _dtype_bytes(cfg.dtype)
    state_rd, state_wr = _state_bytes(cfg, context)
    weight = cfg.active_param_count() * b / batch
    flops = _flops_per_token(cfg, context)
    inst = flops / FLOPS_PER_INST
    read = state_rd + weight
    mpki = (read / hw.CACHE_LINE_B) / inst * 1000.0
    wb = state_wr / read

    # Whole-step roofline on the Table-4 baseline machine.
    terms = roofline_terms(hlo_flops=batch * flops,
                           hlo_bytes=batch * (read + state_wr),
                           collective_bytes=0.0, chips=1, spec=BASELINE_SPEC)
    compute_s = terms["compute_s"]
    memory_s = terms["memory_s"] / MEM_QUEUE_DERATE
    exec_frac = min(max(compute_s / (compute_s + memory_s), 0.02), 0.95)
    cpi = ((compute_s + memory_s) * hw.CORE_CLK_GHZ * 1e9 * hw.SIM_CORES
           / (batch * inst))
    ipc = min(max(1.0 / cpi, 0.02), 2.0)

    ws_mb = min((batch * state_rd + cfg.active_param_count() * b) / 1e6,
                1e6)
    return DecodeDemand(
        arch=cfg.name, family=cfg.family, batch=batch, context=context,
        state_read_bytes=state_rd, state_write_bytes=state_wr,
        weight_bytes=weight, flops_per_token=flops, inst_per_token=inst,
        compute_s=compute_s, memory_s=memory_s, mpki=mpki, wb=wb, ipc=ipc,
        exec_frac=exec_frac, ws_mb=ws_mb)


def llm_workload(cfg: ModelConfig | str, *, batch: int = DEFAULT_BATCH,
                 context: int = DEFAULT_CONTEXT, name: str | None = None,
                 kappa: float = 1.6, eta: float = 1.0, gamma: float = 0.1,
                 pf_boost: float = 1.5) -> Workload:
    """A first-class ``Workload`` for a model config's decode demand.

    The demand vector (ipc, mpki, wb, exec_frac, ws_mb) comes from
    :func:`decode_demand`; the behavioral parameters default to the
    streaming profile (decode reads KV sequentially with MSHRs kept
    full: even banks, prefetch-friendly, few dependent chains) except
    ``kappa``, where serving arrivals are burstier than STREAM's loop.
    """
    d = decode_demand(cfg, batch=batch, context=context)
    if name is None:
        name = f"llm-{d.arch}"
    return Workload(name=name, suite=LLM_SUITE, ipc=d.ipc, mpki=d.mpki,
                    wb=d.wb, kappa=kappa, eta=eta, exec_frac=d.exec_frac,
                    gamma=gamma, pf_boost=pf_boost, ws_mb=d.ws_mb)


def register_llm_workloads(archs, *, batch: int = DEFAULT_BATCH,
                           context: int = DEFAULT_CONTEXT,
                           overwrite: bool = False, **kw) -> tuple:
    """Derive and register one workload per arch; returns them in order.

    Already-registered names are returned as-is unless ``overwrite``."""
    out = []
    for arch in archs:
        w = llm_workload(arch, batch=batch, context=context, **kw)
        try:
            out.append(register_workload(w, overwrite=overwrite))
        except ValueError:
            out.append(by_name(w.name))
    return tuple(out)


def unregister_llm_workloads(archs_or_workloads) -> None:
    """Remove previously registered LLM workloads (no-op for absent)."""
    for item in archs_or_workloads:
        name = getattr(item, "name", None)
        if name is None:
            name = item if str(item).startswith("llm-") else f"llm-{item}"
        try:
            unregister_workload(name)
        except KeyError:
            pass
