"""Production mesh descriptions and the H100's figures for the roofline.

The counterpart of ``repro.launch.mesh``. A mesh here is a plain
description, ``{axis name: size}`` in axis order, with no devices: the dry
run and the roofline only divide tensors over it
(``distributed.sharding.axis_sizes`` reads it, as it reads a
``Mesh`` of torch devices). ``repro``'s ``cost_analysis_dict`` normalises
an XLA compile's cost analysis; PyTorch compiles nothing here, so it has
no counterpart (``launch/roofline.py`` counts FLOPs on the meta device).
"""
from __future__ import annotations

from typing import Dict


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """("data", "model") × (16, 16), or ("pod", "data", "model") × (2, 16,
    16): ``repro``'s production meshes."""
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_host_mesh(data: int = 1, model: int = 1) -> Dict[str, int]:
    """A small ("data", "model") mesh: tests and the one-card check."""
    return {"data": data, "model": model}


def n_devices(mesh: Dict[str, int]) -> int:
    n = 1
    for size in mesh.values():
        n *= size
    return n


# NVIDIA H100 SXM5 (80 GB HBM3) at its 700 W limit, from NVIDIA's H100
# Tensor Core GPU data sheet: per GPU
HW = dict(
    peak_flops_bf16=989e12,  # BF16 Tensor Core, dense (the sheet's 1,979
    #                          TFLOP/s is with 2:4 sparsity)
    hbm_bw=3.35e12,  # GPU memory bandwidth, 3.35 TB/s
    nvlink_bw=900e9,  # NVLink, 900 GB/s aggregate per GPU
    hbm_bytes=80 * 2**30,  # 80 GB of HBM3, counted as 80 GiB
    # The network that bounds a 16 × 16 mesh: NVLink joins the 8 GPUs of
    # one node, so 256 GPUs are 32 nodes, and both axes (16 ranks each)
    # cross nodes. Each GPU of a DGX H100 has its own ConnectX-7 port at
    # 400 Gb/s InfiniBand (NVIDIA DGX H100 data sheet: 8 × 400 Gb/s), 50 GB/s
    # per direction per GPU.
    net_bw=50e9,
)
