"""Target-hardware constants: one NVIDIA H100 80GB HBM3 (SXM5) at its
700 W power limit, the card the port runs on.

Rates are NVIDIA's H100 SXM data sheet figures (dense, no sparsity); a
card set below 700 W runs slower under load, so a measured time is read
beside the card's name and power limit.
"""
import math

from repro_torch.launch.mesh import MESH_SHAPES

# NVIDIA H100 80GB HBM3 at 700 W: dense bf16 tensor-core FLOP/s (H100 SXM
# data sheet: 1,979 TFLOP/s with sparsity, half of it dense), the rate
# chip_smoke.BF16_FLOPS_PER_S bounds the kernels with.
PEAK_FLOPS_BF16 = 989.4e12

# NVIDIA H100 80GB HBM3 at 700 W: HBM3 bytes/s (H100 SXM data sheet: 3.35
# TB/s), chip_smoke.HBM_BYTES_PER_S, the rate behind every kernel bound.
HBM_BW = 3.35e12

# NVIDIA H100 80GB HBM3 at 700 W: NVLink 4 bytes/s a card in one direction
# (H100 SXM data sheet: 900 GB/s over 18 links, both directions together).
LINK_BW = 450e9

# NVIDIA H100 80GB HBM3 at 700 W: device memory in bytes, torch.cuda.
# get_device_properties(0).total_memory as the card reports it (torch
# 2.11.0+cu128); chip_smoke phase 20c prints the card's figure beside it.
HBM_PER_CHIP = 85_017_493_504

# Devices in one production pod: the single-pod mesh of launch/mesh.py.
CHIPS_PER_POD = math.prod(MESH_SHAPES["single_pod"][0])
