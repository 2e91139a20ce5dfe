"""A kernel's least time on the card, from the work its inputs need.

Frozen copy of `chip_smoke.py`'s counts (`FLOPS_WALKED`, `FLOPS_BLENDED`,
`FLOPS_SLOT`, `bound`, the bytes of K2 and K3), so that the count reads
the same work whatever implements the kernel. The least time is the larger
of the fp32 operations over 67 TFLOP/s and the bytes over 3.35 TB/s (one
NVIDIA H100 SXM at 700 W, NVIDIA's data sheet). Operations count an add,
multiply, min / max or compare as one and a fused multiply-add as two; per
pair a pixel walks 16; per pair it blends K2 39 and K3 40 more; per slot
some pixel walks, the projection and the backward's chain: K2 190, K3 107.
Bytes: each input read once (the walked slots' 8 fields, the counts, the
accumulator and its cotangent) and each output written once.
"""
from __future__ import annotations

import torch

from ..reference.ops.rasterizer import cuda_splat as rsplat

PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
FLOPS_WALKED = {"K1": 16, "K2": 16, "K3": 16}
FLOPS_BLENDED = {"K1": 15, "K2": 39, "K3": 40}
FLOPS_SLOT = {"K1": 72, "K2": 190, "K3": 107}


def walk_work(slots8, counts, cp, tiles_x) -> dict:
    """Pairs walked and blended, and slots some pixel walks, over all rows
    (the plain walk, in blocks of rows)."""
    T, _, M = slots8.shape
    tid = torch.arange(T, device=slots8.device)
    n = [0, 0, 0]
    for b in rsplat.row_blocks(T, M):
        w = rsplat._walk(slots8[b], counts[b], cp, tiles_x, tid[b])
        n[0] += int(w["walked"].sum())
        n[1] += int((w["keep"] & w["include"]).sum())
        n[2] += int(w["walked"].any(1).sum())
    return dict(zip(("walked", "blended", "slots"), n))


def kernel_bytes(name: str, T: int, M: int, slots: int) -> int:
    fixed = slots * 8 * 4 + T * 4 + 2 * T * 8 * 256 * 4
    return fixed + (T * 12 * 4 if name == "K2" else T * M * 8 * 4)


def bound_s(name: str, work: dict, nbytes: int) -> tuple[float, str]:
    flops = (work["walked"] * FLOPS_WALKED[name]
             + work["blended"] * FLOPS_BLENDED[name]
             + work["slots"] * FLOPS_SLOT[name])
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FP32_FLOPS
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
