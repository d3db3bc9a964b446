# Copied from src/repro/hw/device.py; imports point at repro_torch.
"""Hardware device models.

A ``DeviceModel`` captures exactly what the DNNVM optimizers need to know:

* on-chip buffer budget (BRAM on the FPGA) split into input /
  weight / output regions, mirroring the paper's pre-allocated BRAM banks
  (B_in, B_weights, B_out in Eq. 6);
* the compute-array parallelism (ic_p, oc_p, h_p);
* clock frequency, off-chip bandwidth, and per-cycle MAC throughput, which
  the time-wheel simulator converts into LOAD/COMPUTE/SAVE lane occupancy.

The paper's published numbers:
  ZU2 @330 MHz: ic_p=24, oc_p=12, h_p=4, 0.66 MB BRAM, peak 380 GOPs/s (int8)
  ZU9 @330 MHz: ic_p=32, oc_p=16, h_p=8, 4 MB BRAM, peak 4.05 TOPs/s¹ (int8)
  (¹ peak at 330 MHz with batch 3; our model uses the single-sample engine.)

``TPU_V5E`` is the reference package's planning model, kept so that
``get_device`` resolves the same names; an H100 model is not defined yet.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DeviceModel:
    name: str
    freq_hz: float                 # clock for the cycle simulator
    ic_p: int                      # parallelism along input channels
    oc_p: int                      # parallelism along output channels
    h_p: int                       # parallelism along feature-map height
    buf_in_bytes: int              # B_in   (Eq. 6)
    buf_weights_bytes: int         # B_weights
    buf_out_bytes: int             # B_out
    dram_bw_bytes_per_s: float     # off-chip bandwidth (DDR / HBM)
    elem_bytes: int = 1            # int8 data path by default (paper §2.3.4)
    # off-chip capacity + alignment for the memory planner (memory/planner.py):
    # activation peak must fit ddr_bytes (0 => unbounded), buffers are placed
    # at ddr_align boundaries (AXI burst alignment).
    ddr_bytes: int = 0
    ddr_align: int = 64
    # engine throughput (elements/cycle).  Calibrated against the paper's own
    # micro-timings (Fig. 8: 3x3 pool over 28x28x256 takes 0.242 ms => ~22
    # elems/cycle on ZU2; Fig. 9: eltwise-add over ~0.8 MB takes 0.833 ms =>
    # ~8 elems/cycle).  0 => derived defaults below.
    pool_lanes: int = 0            # 0 => oc_p * h_p // 2
    misc_lanes: int = 0            # 0 => max(8, oc_p * h_p // 6)
    # ICI for multi-chip rooflines (0 for the FPGA single-chip devices)
    ici_bw_bytes_per_s: float = 0.0
    # Published peak (OPs/s, MAC=2 ops).  The paper's peak numbers (380 GOPs/s
    # ZU2) imply an *effective* MAC rate below the raw ic_p*oc_p*h_p array
    # product (DSP packing bookkeeping); when set, compute cycles are derived
    # from this effective rate while the published (ic_p, oc_p, h_p) still
    # drive tiling and ragged-tile rounding.  0 => use the array product.
    peak_ops_override: float = 0.0

    def replace(self, **overrides) -> "DeviceModel":
        """A copy with some fields overridden.  This is how a calibrated
        ``tune.DeviceProfile`` projects measured effective rates (DRAM
        bandwidth, peak OPs, pool/misc lanes) back onto a device model for
        consumers of the analytic pipeline cost (``profile.to_device_model``);
        the array geometry (ic_p/oc_p/h_p) that drives tiling stays put
        unless explicitly overridden."""
        return dataclasses.replace(self, **overrides)

    @property
    def macs_per_cycle(self) -> int:
        return self.ic_p * self.oc_p * self.h_p

    @property
    def macs_per_cycle_eff(self) -> float:
        if self.peak_ops_override:
            return self.peak_ops_override / (2.0 * self.freq_hz)
        return float(self.macs_per_cycle)

    @property
    def peak_ops_per_s(self) -> float:
        # 1 MAC = 2 ops, the paper's GOPs/s convention.
        return self.peak_ops_override or 2.0 * self.macs_per_cycle * self.freq_hz

    @property
    def onchip_bytes(self) -> int:
        return self.buf_in_bytes + self.buf_weights_bytes + self.buf_out_bytes

    @property
    def pool_elems_per_cycle(self) -> int:
        return self.pool_lanes or max(1, self.oc_p * self.h_p // 2)

    @property
    def misc_elems_per_cycle(self) -> int:
        return self.misc_lanes or max(8, self.oc_p * self.h_p // 6)


# --- The paper's FPGA devices -------------------------------------------------
# BRAM split: the paper pre-allocates fixed banks for ifmaps / weights / ofmaps
# (§3.1); the exact split is unpublished, we use 45% / 35% / 20% which admits
# the paper's own fused examples (Fig. 8: 28x28x32 in, 5x5x32x256 w, 28x28x256
# out tiles).  DDR bandwidth is likewise unpublished; ZU2 boards ship a 32-bit
# DDR4-2400 interface => ~9.6 GB/s theoretical, we model 6.0 GB/s sustained.
_ZU2_BRAM = int(0.66 * 1024 * 1024)
_ZU9_BRAM = 4 * 1024 * 1024

ZU2 = DeviceModel(
    name="zu2",
    freq_hz=330e6,
    ic_p=24, oc_p=12, h_p=4,              # => 380.2 GOPs/s peak, matches paper
    buf_in_bytes=int(_ZU2_BRAM * 0.45),
    buf_weights_bytes=int(_ZU2_BRAM * 0.35),
    buf_out_bytes=int(_ZU2_BRAM * 0.20),
    dram_bw_bytes_per_s=3.4e9,            # calibrated: see EXPERIMENTS.md §Repro
    peak_ops_override=380e9,              # paper's published ZU2 peak
    ddr_bytes=2 * 1024 ** 3,              # 2 GB board DDR4
)

ZU9 = DeviceModel(
    name="zu9",
    freq_hz=330e6,
    ic_p=32, oc_p=16, h_p=8,              # 2.7 TOPs engine; ZU9 runs batch 3
    buf_in_bytes=int(_ZU9_BRAM * 0.45),
    buf_weights_bytes=int(_ZU9_BRAM * 0.35),
    buf_out_bytes=int(_ZU9_BRAM * 0.20),
    dram_bw_bytes_per_s=6.0e9,            # paper §6.2.3 reports bandwidth
                                          # saturation on ZU9; calibrated
    peak_ops_override=4.05e12,            # paper's ZU9 peak (batch-3 engine)
    ddr_bytes=4 * 1024 ** 3,              # 4 GB board DDR4
)

# --- TPU v5e planning model (values as in the reference package) -------------
_V5E_VMEM = 96 * 1024 * 1024

TPU_V5E = DeviceModel(
    name="tpu_v5e",
    freq_hz=940e6,
    ic_p=128, oc_p=128, h_p=8,
    buf_in_bytes=int(_V5E_VMEM * 0.45),
    buf_weights_bytes=int(_V5E_VMEM * 0.35),
    buf_out_bytes=int(_V5E_VMEM * 0.20),
    dram_bw_bytes_per_s=819e9,
    elem_bytes=1,                          # int8 inference data path
    ici_bw_bytes_per_s=50e9,
    peak_ops_override=197e12,
    pool_lanes=1024, misc_lanes=1024,      # VPU 8x128 lanes
    ddr_bytes=16 * 1024 ** 3,              # 16 GB HBM
    ddr_align=512,                         # HBM burst / lane-tile alignment
)

_DEVICES = {d.name: d for d in (ZU2, ZU9, TPU_V5E)}


def get_device(name: str) -> DeviceModel:
    try:
        return _DEVICES[name]
    except KeyError:
        raise KeyError(f"unknown device {name!r}; have {sorted(_DEVICES)}") from None
