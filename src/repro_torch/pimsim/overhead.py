"""CU area/power overhead model — paper §IV-C / Fig. 8.

The paper synthesizes the CU in TSMC 28 nm (Synopsys DC): each PU occupies
14,941 µm² and consumes 4.5 mW; total overhead is 0.8 % of a 32 Gb LPDDR5 die
and +144 mW. We reproduce the breakdown analytically (no synthesis tool in
this environment): component fractions follow the paper's Fig. 8 breakdown of
a MAC-pipeline CU with separated input/output buffers supporting both inner-
and outer-product flows.
"""
from __future__ import annotations

from dataclasses import dataclass

PU_AREA_UM2 = 14941.0
PU_POWER_MW = 4.5
DIE_BITS = 32 * 2**30  # 32 Gb LPDDR5 die

# Component fractions of the CU (MAC pipeline dominates; buffers next).
AREA_BREAKDOWN = {
    "int8_mac_array": 0.46,
    "input_buffer_64B": 0.14,
    "output_buffer_128B": 0.22,
    "accumulator": 0.10,
    "control_mux_inner_outer": 0.08,
}
POWER_BREAKDOWN = {
    "int8_mac_array": 0.52,
    "input_buffer_64B": 0.11,
    "output_buffer_128B": 0.18,
    "accumulator": 0.12,
    "control_mux_inner_outer": 0.07,
}


@dataclass(frozen=True)
class OverheadReport:
    pu_area_um2: float
    pu_power_mw: float
    cus_per_bank: int
    banks_per_die: int
    die_area_fraction: float
    total_power_mw: float

    def rows(self):
        yield ("per-PU area (um^2)", self.pu_area_um2)
        yield ("per-PU power (mW)", self.pu_power_mw)
        yield ("CUs per die", self.cus_per_bank * self.banks_per_die)
        yield ("die area overhead", self.die_area_fraction)
        yield ("total added power (mW)", self.total_power_mw)


def cu_overhead(cus_per_bank: int = 2, banks_per_die: int = 16,
                die_area_mm2: float = 60.0) -> OverheadReport:
    """Paper-reported per-PU numbers scaled to the die.

    0.8 % of die area and 144 mW total (= 32 PUs x 4.5 mW) per §IV-C.
    """
    n = cus_per_bank * banks_per_die
    total_area_mm2 = n * PU_AREA_UM2 / 1e6
    return OverheadReport(
        pu_area_um2=PU_AREA_UM2,
        pu_power_mw=PU_POWER_MW,
        cus_per_bank=cus_per_bank,
        banks_per_die=banks_per_die,
        die_area_fraction=total_area_mm2 / die_area_mm2,
        total_power_mw=n * PU_POWER_MW,
    )
