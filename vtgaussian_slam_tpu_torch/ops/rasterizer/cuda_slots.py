"""Row movement of the binned mapping renderer as two kernels: the slot
gather SG and the slot-inverse sum SI (`csrc/slots.cu`).

  SG `slot_gather`(f8 (M, 8), tab (T, mpt) int64, counts (T,) int32)
      -> (T, 8, mpt) slot planes: slot j of tile t holds row tab[t, j] for
      j < counts[t] and 0 past the count;
  SI `slot_inverse_sum`(rows (P, 8), pos (N, s2) int64, w (N, s2) f32)
      -> (N, 8): sum_k rows[pos[:, k]] w[:, k] in column order, the bits
      of `binning.weighted_inverse`.

Replace no TPU kernel: the JAX package leaves both to XLA
(`binning.gather_channels` and `binning.weighted_inverse` around the splat
kernels). `map_cache.SplatBinned` and the tile-sharded
`parallel.engine.SplatBinnedSharded` gather their planes and map K3's rows
back through them. Each wrapper launches its kernel for CUDA tensors and
counts the launch in its `launches` attribute; the plain PyTorch version
runs only for tensors on the CPU, where it is the arithmetic those callers
had before the kernels. The tracking cache, the truncation probe and the
generic route's records keep `gather_channels`.
"""
from __future__ import annotations

import torch

from . import _build
from .binning import gather_channels, weighted_inverse

NCH = 8


def slot_gather_plain(f8: torch.Tensor, tab: torch.Tensor,
                      counts: torch.Tensor) -> torch.Tensor:
    """Plain SG: `gather_channels(f8, tab)` with the slots past each tile's
    count set to 0."""
    planes = gather_channels(f8, tab)
    past = (torch.arange(tab.shape[1], device=tab.device)[None, :]
            >= counts.to(tab.device)[:, None])
    return planes.masked_fill_(past[:, None, :], 0.0)


def _aligned(t: torch.Tensor) -> bool:
    return t.data_ptr() % 16 == 0


def slot_gather(f8: torch.Tensor, tab: torch.Tensor,
                counts: torch.Tensor) -> torch.Tensor:
    """SG: (M, 8) field rows, an (T, mpt) slot table and its (T,) counts ->
    (T, 8, mpt) planes, 0 past each count."""
    if f8.device.type == "cpu":
        return slot_gather_plain(f8, tab, counts)
    dev = f8.device
    _build.require(f8.dtype == torch.float32 and f8.dim() == 2
                   and f8.shape[1] == NCH and f8.is_contiguous()
                   and _aligned(f8),
                   f"f8 must be contiguous 16-byte aligned f32 (M, {NCH}), "
                   f"got {tuple(f8.shape)} {f8.dtype}")
    _build.require(tab.dtype == torch.int64 and tab.dim() == 2
                   and tab.is_contiguous() and tab.device == dev,
                   "tab must be contiguous int64 (T, mpt) on f8's device")
    T, mpt = tab.shape
    _build.require(counts.dtype == torch.int32 and counts.shape == (T,)
                   and counts.is_contiguous() and counts.device == dev,
                   "counts must be contiguous int32 (T,) on f8's device")
    planes = torch.empty((T, NCH, mpt), dtype=torch.float32, device=dev)
    lib = _build.library("slots")
    err = lib.vtgs_slot_gather(f8.data_ptr(), tab.data_ptr(),
                               counts.data_ptr(), T, mpt, planes.data_ptr(),
                               _build.stream_of(f8))
    _build.check(lib, err, "vtgs_slot_gather launch")
    _build.count_launch(slot_gather)
    return planes


slot_gather.launches = 0


def slot_inverse_sum(rows: torch.Tensor, pos: torch.Tensor,
                     w: torch.Tensor) -> torch.Tensor:
    """SI: (P, 8) per-slot rows, (N, s2) positions in [0, P) and (N, s2)
    weights -> (N, 8) per-Gaussian sums, bit for bit
    `weighted_inverse(rows, pos, w)`."""
    if rows.device.type == "cpu":
        return weighted_inverse(rows, pos, w)
    dev = rows.device
    _build.require(rows.dtype == torch.float32 and rows.dim() == 2
                   and rows.shape[1] == NCH and rows.is_contiguous()
                   and _aligned(rows),
                   f"rows must be contiguous 16-byte aligned f32 "
                   f"(P, {NCH}), got {tuple(rows.shape)} {rows.dtype}")
    _build.require(pos.dtype == torch.int64 and pos.dim() == 2
                   and pos.is_contiguous() and pos.device == dev,
                   "pos must be contiguous int64 (N, s2) on the rows' device")
    N, s2 = pos.shape
    _build.require(w.dtype == torch.float32 and w.shape == (N, s2)
                   and w.is_contiguous() and w.device == dev,
                   "w must be contiguous f32 (N, s2) on the rows' device")
    out = torch.empty((N, NCH), dtype=torch.float32, device=dev)
    lib = _build.library("slots")
    err = lib.vtgs_slot_inverse(rows.data_ptr(), pos.data_ptr(), w.data_ptr(),
                                s2, N, out.data_ptr(), _build.stream_of(rows))
    _build.check(lib, err, "vtgs_slot_inverse launch")
    _build.count_launch(slot_inverse_sum)
    return out


slot_inverse_sum.launches = 0
