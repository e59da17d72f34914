"""repro_torch.serving -- LLM-inference capacity planning on the COAXIAL
engine.

Port of ``repro/serving``; every solve and DES run takes ``device=``
(default the card).

The paper's headline claim is about throughput-oriented servers; the
modern throughput-server workload is LLM decode serving.  This package
connects the repo's serving substrate (``repro_torch.configs``' model
configs, ``repro_torch.core.planner``'s roofline math, the
decode-attention kernel's bytes-per-step arithmetic) to the CoaXiaL
evaluator in three layers:

  :mod:`~repro_torch.serving.demand`    model config -> per-decode-step
                                        memory demand -> a first-class
                                        ``Workload``;
  :mod:`~repro_torch.serving.traffic`   request-rate traces -> per-epoch
                                        (rho, kappa) MMPP operating points;
  :mod:`~repro_torch.serving.capacity`  the planner: which (channels,
                                        LLC, CXL premium, tier split)
                                        meets a p99 token-latency SLO at
                                        minimum area.

CLI: ``python -m repro_torch.serving.plan --arch mistral-large-123b
--slo-p99-ms 60 --trace synthetic-diurnal``.
"""

from repro_torch.serving.capacity import (CapacityPlan, DesignVerdict,
                                          candidate_designs, plan_capacity)
from repro_torch.serving.demand import (DecodeDemand, decode_demand,
                                        llm_workload, register_llm_workloads,
                                        unregister_llm_workloads)
from repro_torch.serving.traffic import (Epoch, Trace, get_trace, load_csv,
                                         poisson_burst, synthetic_diurnal)

__all__ = [
    "DecodeDemand", "decode_demand", "llm_workload",
    "register_llm_workloads", "unregister_llm_workloads",
    "Epoch", "Trace", "get_trace", "load_csv", "poisson_burst",
    "synthetic_diurnal",
    "CapacityPlan", "DesignVerdict", "candidate_designs", "plan_capacity",
]
