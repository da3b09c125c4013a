"""Height-sharded activations: the ``"space"`` axis of a ``("data", "space")`` mesh.

Port of the reference's data x spatial mesh (``adunet/parallel/mesh.py:156-181``
``make_dp_spatial_mesh``; ``batch_sharding`` shards the image height over
``"space"`` and GSPMD inserts the convolutions' halo exchanges). Here each
process of a space group holds its rows of every image, and the exchanges
are written out:

- ``height_split`` is the one rule that gives a shard its rows of a global
  height H: ``[i * H // S, (i + 1) * H // S)``, so shards differ by at most
  one row (205 rows over 2: 102 and 103). Every tensor of a level, the skip
  and the upsampled decoder input alike, is split by its global height, so
  they hold the same rows.
- ``_HaloRows`` (a 3x3 convolution's halo): forward takes k edge rows from
  each neighbour, zeros at the image's border; backward sends the halo rows'
  gradients back to their owners, which add them to their edge rows.
- ``SpaceShard.resize`` (a resize, which ``ops/resize.py`` hands it): along
  H, ``_ResizeRows``, a shard multiplies its output rows' slice of the
  resize matrix by the input rows that slice touches: its own plus the
  band's margin k from each neighbour (``_row_plan``: none for degrade's
  area shrink by 2, 2 rows for its cubic, 1 or 2 for the bilinear resizes
  between levels), and its backward is the transposed product and the
  reverse exchange; along W, the dense product on every device.

Every exchange is one ``all_gather`` of a fixed-size buffer (each process's
first and last k rows) over the space group: gloo takes CUDA tensors for
it, and it needs no point-to-point ``send`` / ``recv``.

Sizes come from the global height, never the tensor's shape: the model's
forward takes the image's height (``AdaptiveSRUNet.forward(x, height=...)``),
the resizes and ``degrade`` take ``space`` and ``height``, and ``Conv`` takes
its halo from the ``SpaceShard`` that ``attach`` set on it. ``SpaceShard``
is the context object: ``adunet_torch.parallel.data_parallel`` makes it from
a mesh with a ``"space"`` axis and sets it on the model.

Only the adaptive SR U-Net is covered (LayerNorm is per pixel, so K1 runs on
a shard's rows unchanged). A model with BatchNorm, ConvTranspose or max-pool
layers raises ``NotImplementedError`` on a space mesh.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from adunet_torch.nn.blocks import BatchNorm, Conv, ConvTranspose
from adunet_torch.kernels.resize_band import resize_band_plain, resize_matrix

__all__ = ["height_split", "SpaceShard", "attach"]


def height_split(height: int, shards: int, index: int) -> Tuple[int, int]:
    """Rows ``[start, stop)`` of a global height that shard ``index`` of
    ``shards`` holds: ``[index * height // shards, (index + 1) * height //
    shards)``. Raises where a shard would hold no row."""
    if height < shards:
        raise ValueError(f"height {height} does not split over {shards} space shards: "
                         "every shard needs a row")
    if not 0 <= index < shards:
        raise ValueError(f"space index {index} outside {shards} shards")
    return index * height // shards, (index + 1) * height // shards


@functools.lru_cache(maxsize=None)
def _row_plan(in_h: int, out_h: int, method: str, antialias: bool,
              shards: int) -> Tuple[int, Tuple[np.ndarray, ...]]:
    """``(k, bands)``: the rows k each shard takes from each neighbour, and
    every shard's slice of the resize matrix over its input rows widened by
    k each side (zero columns beyond the image)."""
    m = resize_matrix(in_h, out_h, method, antialias)
    ins = [height_split(in_h, shards, i) for i in range(shards)]
    outs = [height_split(out_h, shards, i) for i in range(shards)]
    k = 0
    for (i0, i1), (o0, o1) in zip(ins, outs):
        cols = np.flatnonzero(np.any(m[o0:o1] != 0, axis=0))
        if cols.size:
            k = max(k, i0 - int(cols[0]), int(cols[-1]) + 1 - i1)
    if k > min(i1 - i0 for i0, i1 in ins):
        raise ValueError(f"a {method} resize of {in_h} -> {out_h} rows over {shards} space "
                         f"shards needs {k} rows from a neighbour holding fewer")
    padded = np.zeros((out_h, in_h + 2 * k), np.float32)
    padded[:, k : k + in_h] = m
    bands = tuple(np.ascontiguousarray(padded[o0:o1, i0 : i1 + 2 * k])
                  for (i0, i1), (o0, o1) in zip(ins, outs))
    return k, bands


class SpaceShard:
    """This process's place on a mesh's ``"space"`` axis: the group of
    processes that split one image's rows, their count and this one's index.
    ``all_gather`` is the only communication the row exchanges use."""

    def __init__(self, group, shards: int, index: int):
        self.group = group
        self.shards = int(shards)
        self.index = int(index)

    def rows(self, height: int) -> Tuple[int, int]:
        """This shard's rows of a global ``height``."""
        return height_split(height, self.shards, self.index)

    def all_gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every shard's ``t`` (same shape everywhere), in shard order."""
        out = [torch.empty_like(t) for _ in range(self.shards)]
        dist.all_gather(out, t.contiguous(), group=self.group)
        return out

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the shards, in shard order (the same bits on
        every shard)."""
        return torch.stack(self.all_gather(t)).sum(dim=0)

    def global_height(self, local_rows: int, device: torch.device | str = "cpu") -> int:
        """The global height whose ``height_split`` gave every shard its
        rows; raises if the shards' rows were not split so."""
        sizes = [int(v) for v in self.all_gather(
            torch.tensor([local_rows], dtype=torch.int64, device=device))]
        height = sum(sizes)
        want = [b - a for a, b in (height_split(height, self.shards, i)
                                   for i in range(self.shards))]
        if sizes != want:
            raise ValueError(f"the space shards hold {sizes} rows; height_split({height}) "
                             f"gives {want}")
        return height

    def halo(self, x: torch.Tensor, k: int = 1) -> torch.Tensor:
        """(N, h, ...) -> (N, h + 2k, ...): k rows of each neighbour around
        this shard's rows (zeros beyond the image); differentiable."""
        return _HaloRows.apply(x, self, k)

    def resize(self, x: torch.Tensor, out_hw, method: str, antialias: bool, height: int | None,
               dtype: torch.dtype) -> torch.Tensor:
        """This shard's output rows (``dtype``) of the resize of the global
        ``height`` rows of x (..., h, W, C) to the global ``out_hw``: the
        row-sharded product along H, then the dense one along W; differentiable."""
        out_h, out_w = int(out_hw[0]), int(out_hw[1])
        if height is None:
            raise ValueError("a row-sharded resize needs the image's global height")
        *lead, h, w, c = x.shape
        y = x.to(torch.float32)
        if height != out_h:
            y = y.reshape(-1, h, w * c)
            k, bands = _row_plan(height, out_h, method, antialias, self.shards)
            band = _device_band(height, out_h, method, antialias, self.shards, self.index,
                                y.device)
            if h != bands[self.index].shape[1] - 2 * k:
                raise ValueError(f"a shard of {h} rows is not shard {self.index} of "
                                 f"{self.shards} of {height} rows")
            y = _ResizeRows.apply(y, self, band, k)
            h = y.shape[1]
        y = y.reshape(*lead, h, w, c)
        return resize_band_plain(y, (h, out_w), method, antialias).to(dtype)


@functools.lru_cache(maxsize=None)
def _device_band(in_h: int, out_h: int, method: str, antialias: bool, shards: int, index: int,
                 device: torch.device) -> torch.Tensor:
    band = _row_plan(in_h, out_h, method, antialias, shards)[1][index]
    # reusable by a training step after serving; real even under a trace (as
    # adunet_torch.kernels.resize_band._device_matrix)
    with torch.inference_mode(False), _disable_current_modes():
        return torch.from_numpy(band).to(device)


def _with_halo(x: torch.Tensor, space: SpaceShard, k: int) -> torch.Tensor:
    if x.shape[1] < k:
        raise ValueError(f"a shard of {x.shape[1]} rows cannot give its neighbours {k}")
    got = space.all_gather(torch.cat([x[:, :k], x[:, -k:]], dim=1))
    zeros = x.new_zeros(x.shape[0], k, *x.shape[2:])
    above = got[space.index - 1][:, k:] if space.index > 0 else zeros
    below = got[space.index + 1][:, :k] if space.index < space.shards - 1 else zeros
    return torch.cat([above, x, below], dim=1)


def _return_halo(g: torch.Tensor, space: SpaceShard, k: int) -> torch.Tensor:
    """The transpose of ``_with_halo``: this shard's rows' gradient plus the
    gradients its neighbours' halo rows took of its edge rows."""
    got = space.all_gather(torch.cat([g[:, :k], g[:, -k:]], dim=1))
    gx = g[:, k : g.shape[1] - k].clone()
    if space.index > 0:  # the shard above took our first k rows as its lower halo
        gx[:, :k] += got[space.index - 1][:, k:]
    if space.index < space.shards - 1:  # the shard below took our last k as its upper halo
        gx[:, -k:] += got[space.index + 1][:, :k]
    return gx


class _HaloRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, space, k):
        ctx.space, ctx.k = space, k
        return _with_halo(x, space, k)

    @staticmethod
    def backward(ctx, g):
        return _return_halo(g.contiguous(), ctx.space, ctx.k), None, None


class _ResizeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, space, band, k):
        ctx.space, ctx.k = space, k
        ctx.save_for_backward(band)
        return torch.matmul(band, _with_halo(y, space, k) if k else y)

    @staticmethod
    def backward(ctx, g):
        (band,) = ctx.saved_tensors
        gy = torch.matmul(band.t(), g)
        return (_return_halo(gy, ctx.space, ctx.k) if ctx.k else gy), None, None, None


def attach(model: torch.nn.Module, space: SpaceShard) -> None:
    """Set ``space`` on ``model`` and on each of its convolutions, so that its
    forward computes on this shard's rows. Raises ``NotImplementedError`` for
    a model the row-sharded path does not cover."""
    blocked = sorted({type(m).__name__ for m in model.modules()
                      if isinstance(m, (BatchNorm, ConvTranspose))})
    if not getattr(model, "supports_space", False) or blocked:
        raise NotImplementedError(
            f"{type(model).__name__} has no row-sharded path: on a space mesh only the adaptive "
            "SR U-Net (LayerNorm blocks, resizes between levels) trains; BatchNorm, "
            f"ConvTranspose and max-pool layers are not covered (found: {blocked or 'none'})")
    model.space = space
    for m in model.modules():
        if isinstance(m, Conv):
            m.space = space
