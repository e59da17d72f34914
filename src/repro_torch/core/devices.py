"""Measured CXL-device design points (Demystifying CXL Memory, 2303.15375).

Port of ``repro/core/devices.py``.

The paper's Table-2 designs assume an *idealized* CXL premium: the spec's
~30 ns floor (or the 50 ns pessimistic point of §6.4).  Genuine CXL-ready
devices measured by "Demystifying CXL Memory with Genuine CXL-Ready
Systems and Devices" (arXiv 2303.15375) sit well above that floor:
ASIC-controller type-3 devices add on the order of 70-150 ns end-to-end
over a direct DDR access, FPGA-based prototypes 170-250 ns, and the
sustained per-device bandwidth is bounded by the device controller (low
tens of GB/s), not the x8/x16 link.

This module registers those measured profiles as named design points
*beside* the idealized ones, each in the coaxial-4x topology (4 links,
4 DRAM channels behind them, 1 MB LLC/core) so the only thing that
changes design-to-design is the measured latency/bandwidth profile --
"what does the COAXIAL argument look like on hardware you can buy
today".  The numbers are rounded mid-range anchors of
the paper's measured envelopes, not vendor datasheet values:

  ``cxl-dev-a``  ASIC controller + DDR5 back end: +85 ns premium,
                 26/13 GB/s per-link read/write goodput (link-class,
                 controller keeps up).
  ``cxl-dev-b``  ASIC controller + DDR4 back end: +135 ns premium,
                 21/10.5 GB/s (controller-bound below the link).
  ``cxl-dev-c``  FPGA-based prototype: +170 ns premium, 13/6.5 GB/s
                 (soft-logic controller dominates).

Registration is explicit (:func:`register_measured_devices`), matching
the registry idiom -- "configs and the planner register additional
points at runtime" -- so the idealized Table-2 test pins stay exact
unless a caller opts the measured points in.
"""

from __future__ import annotations

from repro_torch.core import hw
from repro_torch.core.cpu_model import COAXIAL_4X, MemSystem

#: Measured-profile design points (see module docstring for provenance).
MEASURED_DEVICES: tuple[MemSystem, ...] = (
    MemSystem(
        "cxl-dev-a", dram_channels=4, links=4,
        link_rd_gbps=hw.CXL_X8_RD_GBPS, link_wr_gbps=hw.CXL_X8_WR_GBPS,
        iface_lat_ns=85.0, llc_mb_per_core=1.0,
        rel_area=COAXIAL_4X.rel_area, rel_pins=COAXIAL_4X.rel_pins),
    MemSystem(
        "cxl-dev-b", dram_channels=4, links=4,
        link_rd_gbps=21.0, link_wr_gbps=10.5,
        iface_lat_ns=135.0, llc_mb_per_core=1.0,
        rel_area=COAXIAL_4X.rel_area, rel_pins=COAXIAL_4X.rel_pins),
    MemSystem(
        "cxl-dev-c", dram_channels=4, links=4,
        link_rd_gbps=13.0, link_wr_gbps=6.5,
        iface_lat_ns=170.0, llc_mb_per_core=1.0,
        rel_area=COAXIAL_4X.rel_area, rel_pins=COAXIAL_4X.rel_pins),
)

MEASURED_NAMES = tuple(d.name for d in MEASURED_DEVICES)


def register_measured_devices(*, overwrite: bool = False) -> tuple:
    """Add every measured-device point to the coaxial design registry.

    Returns the registered points.  Already-registered names are left
    alone unless ``overwrite`` (idempotent opt-in)."""
    from repro_torch.core import coaxial
    out = []
    registered = {d.name for d in coaxial.all_designs()}
    for d in MEASURED_DEVICES:
        if d.name in registered and not overwrite:
            out.append(coaxial.get_design(d.name))
            continue
        out.append(coaxial.register_design(d, overwrite=overwrite))
    return tuple(out)


def unregister_measured_devices() -> None:
    """Remove every measured-device point from the registry (no-op for
    names that are not currently registered)."""
    from repro_torch.core import coaxial
    registered = {d.name for d in coaxial.all_designs()}
    for name in MEASURED_NAMES:
        if name in registered:
            coaxial.unregister_design(name)
