"""Roofline terms of a step: compute, memory and link time.

Port of ``repro/core/planner.py``, :func:`roofline_terms` only.  The
serving demand model (``serving/demand``) phrases the paper's baseline
CPU as a roofline spec and reads the compute and memory terms of a
decode step from it.

The reference module's other functions (``plan_decode_kv``,
``plan_param_channels``, ``asym_schedule``, ``effective_hbm_time`` and
``contention_factor``) plan sharding over a device's links; they wait for
the card's link fields on ``hw.GpuSpec`` (``ROADMAP.md`` item 8).
"""

from __future__ import annotations

import dataclasses


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
