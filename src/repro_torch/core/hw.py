"""Hardware constants for the COAXIAL reproduction and the card it runs on.

Port of ``repro/core/hw.py``.  Two worlds live here:

1. The paper's world (DDR5 / PCIe5 / CXL server memory systems, §2, §4, §5):
   the port's own copy of the reference's constants, value for value.

2. The card the port runs on: ``GpuSpec``, the data-sheet peaks of the
   NVIDIA H100 parts and their NVLink links, picked by the card's name
   with ``spec_for``.  The STREAM probe (``repro_torch.launch.stream``)
   measures HBM bandwidth against ``hbm_bw``; the channel planner
   (``core/planner``) reads the peaks and the links.
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Paper world: DDR5 / CXL (§2, §4.1, §5 "CXL performance modeling")
# ---------------------------------------------------------------------------

#: DDR5-4800 peak channel bandwidth, GB/s (paper §2.3, Table 3).
DDR5_CH_BW_GBPS = 38.4
#: Approximate unloaded DRAM access latency, ns (paper §3.1: "approximated
#: unloaded latency of 40ns").
DRAM_SERVICE_NS = 40.0
#: Cache line size, bytes.
CACHE_LINE_B = 64
#: Simulated core clock, GHz (Table 3).
CORE_CLK_GHZ = 2.0
#: Cores in the scaled-down simulated system (Table 3).
SIM_CORES = 12
#: Per-core MSHR-ish bound on outstanding misses (256-entry ROB, Table 3).
MAX_MLP = 16.0

#: Processor pins per interface (paper §2.3, §4.1).
DDR5_PINS = 160
PCIE_PINS_PER_LANE = 4
PCIE_X8_PINS = 8 * PCIE_PINS_PER_LANE  # 32
#: PCIe 5.0 x8 peak bandwidth PER DIRECTION, GB/s (paper §2.3: the 4x
#: bandwidth-per-pin argument uses this against DDR's combined figure).
PCIE_X8_GBPS_PER_DIR = 32.0

#: Relative silicon area at TSMC 7nm (paper Table 1, rel. to 1MB L3).
AREA_L3_PER_MB = 1.0
AREA_ZEN3_CORE = 6.5
AREA_PCIE_X8 = 5.9
AREA_DDR_CH = 10.8

#: CXL x8 link goodput after PCIe/CXL header overheads (paper §4.1, §5).
CXL_X8_RD_GBPS = 26.0
CXL_X8_WR_GBPS = 13.0
#: CXL-asym (20RX/12TX repurposing of the same 32 pins, §4.3).
CXL_ASYM_RD_GBPS = 32.0
CXL_ASYM_WR_GBPS = 10.0
#: Link traversal latencies, ns (paper §5): x8 is 2.5/5.5 RX/TX,
#: asym is 2/9 RX/TX.  Port adds 12ns per direction.
CXL_PORT_NS_PER_DIR = 12.0
CXL_X8_LINK_RX_NS = 2.5
CXL_X8_LINK_TX_NS = 5.5
CXL_ASYM_LINK_RX_NS = 2.0
CXL_ASYM_LINK_TX_NS = 9.0
#: Default end-to-end CXL interface latency premium, ns (paper §2.4, §5:
#: "minimum latency overhead of about 30ns"), and the pessimistic
#: sensitivity point (§6.4).
CXL_LAT_NS = 30.0
CXL_LAT_PESSIMISTIC_NS = 50.0

#: Power model constants (paper §6.6, Table 5).
PKG_POWER_W = 500.0
DDR_MC_PHY_W_PER_CH = 13.0 / 12.0       # baseline: 13W for 12 channels
PCIE_LANE_POWER_W = 0.2                  # per lane, PCIe 5.0 [4]
#: DIMM power, per DDR5 channel: P = static + dynamic * utilization.  The
#: two coefficients are fitted to the paper's own two anchor points
#: (200W @ 52% util on 12 ch; 551W @ 21% util on 48 ch) -- see DESIGN.md.
DIMM_STATIC_W_PER_CH = 7.97
DIMM_DYN_W_PER_CH = 16.74


# ---------------------------------------------------------------------------
# The card: NVIDIA H100 (data sheets, dense rates without sparsity).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GpuSpec:
    """Roofline-relevant peaks of one card and of its NVLink links."""

    #: The part, as it appears in the card's name ("SXM", "PCIe", "NVL").
    part: str
    #: HBM bandwidth, bytes/s.
    hbm_bw: float
    #: Peak bf16 tensor-core throughput, FLOP/s.
    peak_bf16_flops: float
    #: Peak fp32 throughput of the CUDA cores, FLOP/s.
    peak_fp32_flops: float
    #: HBM capacity, bytes.
    hbm_bytes: int
    #: L2 cache, bytes.
    l2_bytes: int
    #: NVLink bandwidth of one link IN ONE DIRECTION, bytes/s.  The data
    #: sheets give each part's total over both directions (SXM: 900 GB/s
    #: over 18 NVLink-4 links, 50 GB/s a link); a channel's combine
    #: traffic flows one way, so the planner reads half of it.
    nvlink_bw_per_link: float
    #: NVLink links of one card.
    nvlink_links: int
    #: Latency of one stage of a combine between two cards over NVLink,
    #: seconds.  No data sheet gives it: 3 us is an ESTIMATE of a small
    #: peer-to-peer exchange with its launch and signal, not measured on
    #: any card of this repo's runs.
    nvlink_hop_s: float

    @property
    def link_bw(self) -> float:
        """Aggregate NVLink bandwidth of one card in one direction,
        bytes/s."""
        return self.nvlink_bw_per_link * self.nvlink_links


# The PCIe and NVL parts' 600 GB/s (both directions, over their NVLink
# bridges) is 12 links of the SXM part's 50 GB/s.
H100_SXM = GpuSpec("SXM", 3.35e12, 989e12, 67e12, 80 * 10**9, 50 * 2**20,
                   25e9, 18, 3e-6)
H100_PCIE = GpuSpec("PCIe", 2.0e12, 756e12, 51e12, 80 * 10**9, 50 * 2**20,
                    25e9, 12, 3e-6)
H100_NVL = GpuSpec("NVL", 3.9e12, 835e12, 60e12, 94 * 10**9, 50 * 2**20,
                   25e9, 12, 3e-6)


def spec_for(device_name: str) -> GpuSpec:
    """The H100 part a card's name (``torch.cuda.get_device_name``) names;
    the SXM part when it names neither PCIe nor NVL."""
    for spec in (H100_PCIE, H100_NVL):
        if spec.part in device_name:
            return spec
    return H100_SXM
