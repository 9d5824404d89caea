"""Platform models for the UM simulator — the paper's three test systems
(§III-B), a Grace-Hopper-class coherent superchip (beyond-paper
extrapolation) and the H100 host-attach point the port targets.  The port's
copy of ``repro.umbench.platforms``, with ``H100_HOST`` in the place of the
reference's own host-attach point.

Calibration sources: PCIe Gen3 x16 effective ~12 GB/s; NVLink2 CPU<->GPU
effective ~60 GB/s (paper cites Pearson et al. ICPE'19 microbenchmarks);
fault-group handling latencies from Sakharnykh GTC'17 (tens of us per group,
lower on P9 due to ATS).  Device numbers: GTX 1050 Ti (4 GB, 112 GB/s,
~2.1 TFLOP/s fp32); V100 (16 GB, 900 GB/s, ~14 TFLOP/s fp32).
GH200: H100 96 GB HBM3 (~3.4 TB/s, ~67 TFLOP/s fp32) with the NVLink-C2C
hardware-coherent link (~450 GB/s effective per direction); 'Harnessing
Integrated CPU-GPU System Memory for HPC: a first look into Grace Hopper'
reports near-bulk fault-driven migration and low ATS handling latency.

H100_HOST: an H100 SXM5 80GB on a PCIe Gen5 x16 host link, every number
from NVIDIA's H100 Tensor Core GPU data sheet (SXM5 column): 80 GB of HBM3,
3.35 TB/s of memory bandwidth, 67 TFLOP/s fp32 (the apps' dtype, outside
the tensor cores), and PCIe Gen5 at 128 GB/s both ways, 64 GB/s one way.
Like every platform here, a data-sheet GB/s is multiplied by the
simulator's ``GB`` (2**30), so 3,350 reads as 3.597e12 B/s.  The card's
measured values sit beside these constants in ``chip_smoke.py``'s
``um_path`` phase.
"""
from __future__ import annotations

from repro_torch.core.simulator import GB, SimPlatform

INTEL_PASCAL = SimPlatform(
    name="intel-pascal-pcie",
    device_mem_gb=4.0,
    link_bw_gbs=12.0,
    device_bw_gbs=112.0,
    device_flops_tps=2.1,
    fault_latency_us=45.0,
    host_can_access_device=False,
    device_can_access_host=True,
    fault_migration_efficiency=0.35,
)

INTEL_VOLTA = SimPlatform(
    name="intel-volta-pcie",
    device_mem_gb=16.0,
    link_bw_gbs=12.0,
    device_bw_gbs=900.0,
    device_flops_tps=14.0,
    fault_latency_us=45.0,
    host_can_access_device=False,
    device_can_access_host=True,
    fault_migration_efficiency=0.30,
)

P9_VOLTA = SimPlatform(
    name="p9-volta-nvlink",
    device_mem_gb=16.0,
    link_bw_gbs=60.0,
    device_bw_gbs=900.0,
    device_flops_tps=14.0,
    fault_latency_us=20.0,
    host_can_access_device=True,   # ATS: CPU can map GPU memory
    device_can_access_host=True,
    fault_migration_efficiency=0.85,  # coherent fabric: near-bulk fault paths
)

GRACE_HOPPER = SimPlatform(
    name="grace-hopper-c2c",
    device_mem_gb=96.0,
    link_bw_gbs=450.0,
    device_bw_gbs=3400.0,
    device_flops_tps=67.0,
    fault_latency_us=8.0,            # hardware ATS walk, no host IRQ round-trip
    host_can_access_device=True,     # C2C: fully coherent in both directions
    device_can_access_host=True,
    fault_migration_efficiency=0.9,  # near-bulk fault paths (GH paper §4)
    remote_access_efficiency=0.8,
)

H100_HOST = SimPlatform(
    name="h100-host",
    device_mem_gb=80.0,            # data sheet: 80 GB HBM3
    link_bw_gbs=64.0,              # data sheet: PCIe Gen5 128 GB/s, one direction
    device_bw_gbs=3350.0,          # data sheet: 3.35 TB/s
    device_flops_tps=67.0,         # data sheet: 67 TFLOP/s fp32
    fault_latency_us=0.0,          # no page faults: the port plans every transfer
    host_can_access_device=False,  # (core/placement.py, core/prefetch.py)
    device_can_access_host=True,
)

PLATFORMS = {
    p.name: p
    for p in (INTEL_PASCAL, INTEL_VOLTA, P9_VOLTA, GRACE_HOPPER, H100_HOST)
}

def working_set_chunks(platform: SimPlatform, regime_frac: float,
                       granularity: str = "group") -> int:
    """Chunk count of a regime's working set on ``platform`` at the given
    granularity — the sweep-scale number the page-granularity mode is sized
    by (~400k 64 KB pages per 1.5x-oversubscribed region on a 16 GB card,
    ~2.4M on the 96 GB superchip)."""
    chunk = (platform.page_bytes if granularity == "page"
             else platform.fault_group_bytes)
    return int(regime_frac * platform.device_mem_gb * GB) // chunk
