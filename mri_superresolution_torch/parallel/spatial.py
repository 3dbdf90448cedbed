"""Row-sharded (spatial) forwards and training loss of the four model
families.

The port of the JAX package's ``parallel/spatial.py``. A slice's ROW axis
is split over the ``n_space`` shards of a space group, and the forward
runs on the row blocks with explicit collectives:

- a kxk conv takes ``(k//2)``-row halos from its neighbours (the group's
  ``halo``); the two edge shards get zero rows, which is the dense conv's
  zero padding, and the columns pad locally;
- GroupNorm statistics are whole-image: local fp32 sums are added over
  the group (``all_sum``), in shard order and once, so that every shard
  normalizes with the same bits;
- the align_corners bilinear 2x row upsample is position-dependent: each
  shard applies its own slice of the global upsample matrix to a 1-row
  haloed block (:func:`_upsample_rows_matrices`);
- max-pool, pixel-shuffle, the blends and the column work are local.

A :class:`SpatialMesh` is a (n_data, n_space) grid over a device pool:
the batch splits over its rows (data groups), a slice's rows over the
devices of a row (a space group). Every block function takes and returns
a list of the row blocks a group holds, one tensor a block, and only
calls the group's ``map``, ``halo``, ``all_sum``, ``all_max``,
``data_sum`` and ``world_max``. A group's ``n`` is the number of shards
an image is cut into, and ``shards`` the space index of each block it
holds. Two groups implement them:

- :class:`SpaceGroup`, in this process: its blocks are a list of tensors
  on its devices, a halo is a copy of the neighbour's edge rows, a sum
  adds the blocks' tensors. It serves one data group (``range(n)``) or,
  for the training loss, every block of a mesh, data-major;
- :class:`RankSpaceGroup`, over ``torch.distributed``: this rank holds
  one block (``[s]``) of a (n_data, n_space) grid of ranks
  (:class:`RankMesh`), and the collectives are ``autograd.Function`` s
  over its space and data subgroups: a halo's backward returns the
  gradient of the received rows to the rank that owns them, a sum's
  backward sums the incoming gradients over the same group.

Kernels on the shard path:

- B3 (``kernels.conv3x3``) at the unet's ``final_up_conv`` and
  ``final_conv1``: it runs on the 1-row haloed block, pads all four sides
  with zeros itself, and the first and last of its output rows are
  cropped; the rows left are the dense kernel's on the same input rows.
  In training the crop sends the gradient of the halo rows into the
  halo's backward, and B3's backward is PyTorch's convolution gradient
  (``kernels.conv3x3``), as the JAX kernel's is XLA's.
- B4's stream kernel (``kernels.leaky_quantize``) at every int8 site:
  each site's input is quantized on its own rows BEFORE the halo exchange
  (elementwise, with replicated per-channel scales), so the neighbours'
  s8 halo rows are the dense quantize of those rows, the edge zeros are
  the quantize of the dense zero padding, and the s8 x s8 -> s32 sum a
  pixel is the dense int8 conv's (``ops/quant.int8_conv``). A site after
  a GroupNorm quantizes with slope 0.2 (the LeakyReLU folded in), every
  other site with 1.0 (an input already activated).
- B1 is not on the path: a GroupNorm needs whole-image statistics, and
  B1 computes them from the block it is given. The GroupNorms here are
  torch ops on fp32 sums, as JAX's are ``jnp`` plus a ``psum``. B2 is not
  either: the sharded SSIM is a haloed blur and sums
  (:func:`_ssim_per_sample_sharded`), as JAX's is ``jnp``.

Launches a forward of one chunk over n shards: unet B3 2n in bf16 and
fp32 (none in int8 and QAT, where those are quantized sites); int8 B4 one
per quantized site and shard (unet and unet_tpu 20n, edsr 18n with 8
blocks, simple 2n); B1 and ``gn_quantize`` none. A training step adds
B3's backward, PyTorch's, to each B3 launch.

Constraints (checked when a forward or loss is built): H % (8 * n_space)
== 0 and W % 8 == 0, so the three pools stay shard-local and every halo
comes from the next shard alone. Parameters are the port's state_dict of
the family, the dense model's, so every checkpoint serves and trains.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
import torch.utils.checkpoint

from mri_superresolution_torch.kernels import conv3x3, leaky_quantize
from mri_superresolution_torch.ops import ssim as _ssim
from mri_superresolution_torch.ops.functional import (GN_EPS, max_pool2,
                                                      pixel_shuffle)
from mri_superresolution_torch.ops.quant import (FOREGROUND_INTENSITY,
                                                 fake_quant_act,
                                                 fake_quant_kernel, int8_conv,
                                                 ste)
from mri_superresolution_torch.ops.resize import _align_corners_matrix

CL = torch.channels_last
_GROUPS = 8
_SLOPE = 0.2


def _device_ctx(dev: torch.device):
    """The CUDA device context of ``dev`` where it is not the current
    device already, so that a kernel launched on a shard finds its
    device; nothing on the CPU."""
    if dev.type == "cuda" and dev.index is not None and \
            dev.index != torch.cuda.current_device():
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class SpaceGroup:
    """The collectives of row blocks held in this process, one a device
    of ``devices``: ``n_data`` rows of ``n`` blocks, data-major, each row
    one batch chunk's row blocks in row order (``n_data`` 1: one space
    group, as serving runs them).

    ``halo``, ``all_sum`` and the other collectives take a list of the
    blocks' tensors (block i on ``devices[i]``) and return one. Nothing
    is written in place: on a device named twice, a received halo or a
    summed statistic is a view of another block's tensor. Every result is
    differentiable (``.to`` and ``torch.cat`` carry gradients), so that
    the training loss runs here as it runs over ranks."""

    def __init__(self, devices: Sequence, n_data: int = 1):
        self.devices = [torch.device(d) for d in devices]
        if n_data < 1 or len(self.devices) % n_data:
            raise ValueError(f"{len(self.devices)} blocks do not make "
                             f"{n_data} equal rows")
        self.n_data = n_data
        self.n = len(self.devices) // n_data
        self.shards = [i % self.n for i in range(len(self.devices))]

    def map(self, fn, *lists) -> list:
        """``[fn(a_i, b_i, ...)]`` over the blocks, each under its own
        device's context."""
        out = []
        for i, args in enumerate(zip(*lists)):
            with _device_ctx(self.devices[i]):
                out.append(fn(*args))
        return out

    def halo(self, xs: List[torch.Tensor], up: int, down: int) -> list:
        """Each (B, C, h, W) block extended by ``up`` rows of the previous
        shard and ``down`` rows of the next one, channels_last; the edge
        shards get zero rows."""
        if not (up or down):
            return xs
        out = []
        for i, x in enumerate(xs):
            b, c, _, w = x.shape
            s = self.shards[i]
            parts = []
            if up:
                parts.append(xs[i - 1][:, :, -up:].to(x.device) if s > 0
                             else x.new_zeros((b, c, up, w)))
            parts.append(x)
            if down:
                parts.append(xs[i + 1][:, :, :down].to(x.device)
                             if s < self.n - 1
                             else x.new_zeros((b, c, down, w)))
            out.append(torch.cat(parts, dim=2).contiguous(memory_format=CL))
        return out

    def _reduce(self, ts, op, members) -> list:
        out = [None] * len(ts)
        for idx in members:
            total = ts[idx[0]]
            for j in idx[1:]:
                total = op(total, ts[j].to(total.device))
            # one result, handed to every member: the same bits everywhere
            for j in idx:
                out[j] = total.to(self.devices[j])
        return out

    def _rows(self) -> list:
        return [list(range(r * self.n, (r + 1) * self.n))
                for r in range(self.n_data)]

    def all_sum(self, ts: List[torch.Tensor]) -> list:
        """The sum over each space group of its blocks' tensors, in shard
        order, once, on every block's device."""
        return self._reduce(ts, torch.add, self._rows())

    def all_max(self, ts: List[torch.Tensor]) -> list:
        return self._reduce(ts, torch.maximum, self._rows())

    def data_sum(self, ts: List[torch.Tensor]) -> list:
        """The sum over each data group (the blocks of one space index in
        every row), in row order."""
        return self._reduce(ts, torch.add, [
            list(range(s, len(ts), self.n)) for s in range(self.n)])

    def world_max(self, ts: List[torch.Tensor]) -> list:
        """The max over every block (a detached statistic)."""
        return self._reduce([t.detach() for t in ts], torch.maximum,
                            [list(range(len(ts)))])


def _gather(t: torch.Tensor, pg, n: int) -> List[torch.Tensor]:
    """Every rank's ``t`` (one shape on each) in ``pg``'s rank order, in
    t's dtype. Sent as fp32, which holds bf16 exactly: gloo, which runs
    two ranks on one card, takes fp32 tensors on a card."""
    src = t.detach().float().contiguous()
    parts = [torch.empty_like(src) for _ in range(n)]
    dist.all_gather(parts, src, group=pg)
    return [p.to(t.dtype) for p in parts]


def _ordered_sum(parts: List[torch.Tensor]) -> torch.Tensor:
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


class _RankSum(torch.autograd.Function):
    """The sum of a tensor over the ranks of ``pg``, in rank order, the
    same bits on each; the backward is the same sum of the incoming
    gradients, since every rank's input reaches every rank's output."""

    @staticmethod
    def forward(ctx, t, pg, n):
        ctx.pg, ctx.n = pg, n
        return _ordered_sum(_gather(t, pg, n))

    @staticmethod
    def backward(ctx, g):
        return _ordered_sum(_gather(g, ctx.pg, ctx.n)), None, None


class _RankHalo(torch.autograd.Function):
    """This rank's (B, C, h, W) block extended by ``up`` rows of the
    previous space rank and ``down`` rows of the next, zero rows at the
    image's edges. One all-gather of every rank's first ``down`` and last
    ``up`` rows, on every rank of the group, edge ranks included; the
    backward gathers the gradient of the received rows the same way and
    adds each into the edge rows of the rank that sent them."""

    @staticmethod
    def forward(ctx, x, up, down, group):
        b, c, h, w = x.shape
        ctx.up, ctx.down, ctx.group, ctx.h = up, down, group, h
        sent = torch.cat([x[:, :, :down].reshape(-1),
                          x[:, :, h - up:].reshape(-1)])
        parts = _gather(sent, group.space_pg, group.n)
        s, n, k = group.s, group.n, b * c * down * w
        pieces = []
        if up:
            pieces.append(parts[s - 1][k:].reshape(b, c, up, w) if s > 0
                          else x.new_zeros((b, c, up, w)))
        pieces.append(x)
        if down:
            pieces.append(parts[s + 1][:k].reshape(b, c, down, w)
                          if s < n - 1 else x.new_zeros((b, c, down, w)))
        return torch.cat(pieces, dim=2).contiguous(memory_format=CL)

    @staticmethod
    def backward(ctx, g):
        up, down, group, h = ctx.up, ctx.down, ctx.group, ctx.h
        b, c, _, w = g.shape
        # the gradient of the previous rank's last rows, then of the next
        # rank's first rows
        sent = torch.cat([g[:, :, :up].reshape(-1),
                          g[:, :, up + h:].reshape(-1)])
        parts = _gather(sent, group.space_pg, group.n)
        s, n, k = group.s, group.n, b * c * up * w
        dx = g[:, :, up:up + h].clone(memory_format=CL)
        if up and s < n - 1:
            dx[:, :, h - up:] += parts[s + 1][:k].reshape(b, c, up, w)
        if down and s > 0:
            dx[:, :, :down] += parts[s - 1][k:].reshape(b, c, down, w)
        return dx, None, None, None


def _rank_max(t: torch.Tensor, pg) -> torch.Tensor:
    out = t.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=pg)
    return out


class RankSpaceGroup:
    """:class:`SpaceGroup`'s collectives for a rank of a process group
    that holds one row block: shard ``s`` of the ``n`` of its space group
    (``space_pg``), in data group ``g`` of ``n_data`` (``data_pg``, the
    ranks of space index ``s``). Halos and sums are
    ``autograd.Function`` s (:class:`_RankHalo`, :class:`_RankSum`);
    ``all_max`` and ``world_max`` reduce detached statistics. Every rank
    of a group must make the same calls in the same order."""

    def __init__(self, device, s: int, n: int, g: int, n_data: int,
                 space_pg, data_pg):
        self.devices = [torch.device(device)]
        self.s, self.n, self.g, self.n_data = s, n, g, n_data
        self.shards = [s]
        self.space_pg, self.data_pg = space_pg, data_pg

    map = SpaceGroup.map

    def halo(self, xs, up: int, down: int) -> list:
        if not (up or down):
            return xs
        return [_RankHalo.apply(xs[0], up, down, self)]

    def all_sum(self, ts) -> list:
        return [_RankSum.apply(ts[0], self.space_pg, self.n)]

    def all_max(self, ts) -> list:
        return [_rank_max(ts[0], self.space_pg)]

    def data_sum(self, ts) -> list:
        if self.n_data == 1:
            return list(ts)
        return [_RankSum.apply(ts[0], self.data_pg, self.n_data)]

    def world_max(self, ts) -> list:
        return [_rank_max(ts[0], None)]

    def gather_rows(self, y: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole images of this rank's block ``y``: every space rank's
        block, joined along the row axis ``dim`` (a collective of the
        space group)."""
        return torch.cat(_gather(y, self.space_pg, self.n), dim=dim)


class SpatialMesh:
    """A (n_data, n_space) grid of devices in this process: ``grid[g]`` is
    data group g's space group, its devices in row order."""

    def __init__(self, grid: Sequence[Sequence]):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        if not self.grid or len({len(r) for r in self.grid}) != 1:
            raise ValueError("a spatial mesh needs equal, non-empty rows")
        self.shape = (len(self.grid), len(self.grid[0]))
        self.groups = [SpaceGroup(row) for row in self.grid]
        self._train_group = None

    @property
    def devices(self) -> list:
        return [d for row in self.grid for d in row]

    def row(self, g: int) -> "SpatialMesh":
        """Data group ``g`` alone, as a mesh of one row."""
        return SpatialMesh([self.grid[g]])

    # the training loss's view: every block of the mesh in one group
    def train_group(self) -> SpaceGroup:
        if self._train_group is None:
            self._train_group = SpaceGroup(self.devices, self.shape[0])
        return self._train_group

    def split(self, x: torch.Tensor) -> list:
        """The blocks of a global (B, H, ...) batch, data-major: data
        group g's rows of the batch, shard s's rows of the images."""
        n_data, n_space = self.shape
        if x.shape[0] % n_data:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{n_data} data groups")
        bl, hl = x.shape[0] // n_data, x.shape[1] // n_space
        return [x[g * bl:(g + 1) * bl, s * hl:(s + 1) * hl].to(d)
                for g, row in enumerate(self.grid) for s, d in enumerate(row)]

    def split_weights(self, w: torch.Tensor) -> list:
        n_data, n_space = self.shape
        bl = w.shape[0] // n_data
        return [w[g * bl:(g + 1) * bl].to(d)
                for g, row in enumerate(self.grid) for d in row]

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rows of a batch this process holds: all of them."""
        return x

    def weight_sum(self, w: torch.Tensor) -> torch.Tensor:
        """The weight sum of the global batch ``w``."""
        return w.detach().float().sum()

    def join(self, ys: list, like: torch.Tensor) -> torch.Tensor:
        """The global batch of the blocks ``ys`` on ``like``'s device."""
        n = self.shape[1]
        rows = [torch.cat([y.to(like.device) for y in ys[i:i + n]], dim=1)
                for i in range(0, len(ys), n)]
        return torch.cat(rows) if len(rows) > 1 else rows[0]


class RankMesh:
    """The ranks of this process group as a (n_data, n_space) grid,
    data-major, as ``make_spatial_mesh`` orders devices: rank ``g *
    n_space + s`` holds shard s of data group g's images on ``device``.
    Every rank creates every subgroup, in the same order (a collective):
    the space groups (consecutive ranks) and the data groups (the ranks
    of one space index, for the loss's global weighted mean and ZeRO-1).
    The loss of such a mesh takes and returns this rank's blocks."""

    def __init__(self, n_data: int, n_space: int, device):
        world, rank = dist.get_world_size(), dist.get_rank()
        if n_data * n_space != world:
            raise ValueError(f"a ({n_data}, {n_space}) mesh needs "
                             f"{n_data * n_space} ranks, the group has "
                             f"{world}")
        self.shape = (n_data, n_space)
        self.g, self.s = divmod(rank, n_space)
        space = [dist.new_group(list(range(g * n_space, (g + 1) * n_space)))
                 for g in range(n_data)]
        data = [dist.new_group(list(range(s, world, n_space)))
                for s in range(n_space)] if n_data > 1 else [None] * n_space
        self.data_pg = data[self.s]
        self.devices = [torch.device(device)]
        self.group = RankSpaceGroup(device, self.s, n_space, self.g, n_data,
                                    space[self.g], self.data_pg)

    def train_group(self) -> RankSpaceGroup:
        return self.group

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows (dim 1) of a batch of whole images."""
        h = x.shape[1] // self.shape[1]
        return x[:, self.s * h:(self.s + 1) * h]

    def weight_sum(self, w: torch.Tensor) -> torch.Tensor:
        """The global batch's weight sum from this data group's weights
        ``w`` (a collective of the data group)."""
        return self.group.data_sum([w.detach().float().sum()])[0]

    def split(self, x: torch.Tensor) -> list:
        return [x]

    split_weights = split

    def join(self, ys: list, like: torch.Tensor) -> torch.Tensor:
        return ys[0]


def make_spatial_mesh(n_data: int, n_space: int,
                      devices: Optional[Sequence] = None) -> SpatialMesh:
    """A (n_data, n_space) grid over the first n_data * n_space devices of
    ``devices``, default the visible GPUs (the CPU is used only when the
    caller names it). A device may appear more than once."""
    n = n_data * n_space
    if devices is None:
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError(
                "no CUDA device is available; pass devices=[torch.device("
                "'cpu')] * n to run on the CPU")
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    if len(devices) < n:
        raise ValueError(f"a ({n_data}, {n_space}) spatial mesh needs {n} "
                         f"devices, got {len(devices)}")
    return SpatialMesh([devices[g * n_space:(g + 1) * n_space]
                        for g in range(n_data)])


# ------------------------------------------------------------ block ops

def _none(group) -> list:
    return [None] * len(group.shards)


def _conv(group, xs, ws, dtype, bs=None):
    """A kxk conv (stride 1, 'same' zero padding) on row blocks, shard i
    with weight ``ws[i]`` (and bias ``bs[i]``): row halos of k//2 replace
    the dense row padding, the columns pad locally."""
    kh, kw = ws[0].shape[2], ws[0].shape[3]
    xs = group.halo(xs, kh // 2, kh // 2)

    def one(x, w, b):
        return F.conv2d(x, w.to(dtype), None if b is None else b.to(dtype),
                        padding=(0, kw // 2)).contiguous(memory_format=CL)
    return group.map(one, xs, ws, bs or _none(group))


def _narrow_conv(group, xs, ws, dtype):
    """The unet's narrow-Cout 3x3 convs on kernel B3: the kernel runs on
    the 1-row haloed block and the two rows it padded itself are
    cropped."""
    xs = group.halo(xs, 1, 1)

    def one(x, w):
        return conv3x3(x, w.to(dtype, memory_format=CL))[:, :, 1:-1]
    return group.map(one, xs, ws)


def _group_norm(group, xs, ws, bs, slope=None, residual=None):
    """GroupNorm(8) with whole-image statistics: local fp32 sums, added
    over the group, the affine in fp32 and a cast back to the block's
    dtype; then LeakyReLU(``slope``) and the residual, in that dtype."""
    b, c, h, w = xs[0].shape
    cg = c // _GROUPS

    def sums(x):
        xf = x.float().reshape(b, _GROUPS, cg, h, w)
        return torch.stack([xf.sum(dim=(2, 3, 4)),
                            (xf * xf).sum(dim=(2, 3, 4))])
    n_elems = h * w * cg * group.n
    stats = group.all_sum(group.map(sums, xs))

    def norm(x, st, scale, bias, res):
        mean = st[0] / n_elems
        var = st[1] / n_elems - mean * mean
        mul = torch.rsqrt(var + GN_EPS)
        mean_c = mean.repeat_interleave(cg, dim=1).view(b, c, 1, 1)
        mul_c = mul.repeat_interleave(cg, dim=1).view(b, c, 1, 1)
        y = (x.float() - mean_c) * mul_c
        y = y * scale.float().view(1, c, 1, 1) + bias.float().view(1, c, 1, 1)
        y = y.to(x.dtype)
        if slope is not None:
            y = F.leaky_relu(y, slope)
        if res is not None:
            y = y + res
        return y.contiguous(memory_format=CL)
    return group.map(norm, xs, stats, ws, bs, residual or _none(group))


def _upsample_rows_matrices(h_global: int, n_space: int) -> np.ndarray:
    """Each shard's slice of the align_corners 2x row-upsample matrix.

    Shard d emits output rows [2 d hl, 2 (d + 1) hl) from input rows
    [d hl - 1, (d + 1) hl + 1): a 1-row halo each side, as far as an
    align_corners tap reaches. Returns (n_space, 2 hl, hl + 2)."""
    hl = h_global // n_space
    a = np.pad(_align_corners_matrix(h_global, 2 * h_global),
               ((0, 0), (1, 1)))                       # zero halo columns
    return np.stack([a[2 * d * hl: 2 * (d + 1) * hl, d * hl: (d + 1) * hl + 2]
                     for d in range(n_space)])


class _Operators:
    """The upsample matrices of one forward shape, on each device and
    dtype they are asked for once: the row slices of each decoder
    resolution, keyed by the GLOBAL row count, and the column matrices,
    keyed by the column count. Filled eagerly, so that a traced program
    (``infer/export.py``) reads them as constants."""

    def __init__(self, n_space: int):
        self.n_space = n_space
        self._cache: Dict[tuple, torch.Tensor] = {}

    def _get(self, key, make, dev, dtype):
        k = key + (str(dev), dtype)
        if k not in self._cache:
            with torch.inference_mode(False):
                self._cache[k] = torch.from_numpy(make()).to(dev, dtype)
        return self._cache[k]

    def rows(self, h_global: int, shard: int, dev, dtype):
        m = self._get(("rows", h_global), lambda: np.ascontiguousarray(
            _upsample_rows_matrices(h_global, self.n_space)), dev, dtype)
        return m[shard]

    def cols(self, w: int, dev, dtype):
        return self._get(("cols", w), lambda: _align_corners_matrix(
            w, 2 * w), dev, dtype)


def _upsample2x(group, ops: _Operators, xs):
    """2x align_corners bilinear of row blocks: the shard's row matrix on
    its 1-row haloed block, then the full column matrix; the dense
    ``ops/resize.upsample_bilinear_align_corners`` order and dtype, its
    row matrix replaced by the shard's slice."""
    h_global = xs[0].shape[2] * group.n
    xs = group.halo(xs, 1, 1)

    def one(i, x):
        b, c, hp, w = x.shape
        wr = ops.rows(h_global, i, x.device, x.dtype)
        wc = ops.cols(w, x.device, x.dtype)
        t = x.permute(0, 2, 3, 1).reshape(b, hp, w * c)
        y = torch.matmul(wr, t)                              # (b, 2hl, w*c)
        y = torch.matmul(wc, y.reshape(-1, w, c))            # (b*2hl, 2w, c)
        return y.reshape(b, wr.shape[0], 2 * w, c).permute(0, 3, 1, 2) \
            .contiguous(memory_format=CL)
    return group.map(one, group.shards, xs)


# ------------------------------------------------- int8 and QAT contexts

class _QServeCtx:
    """Frozen-scale int8 serving: ``scales[dev]`` maps the dense int8
    forward's site names to per-Cin activation scales and ``qweights[dev]``
    to each site's ``(q_kernel, k_scale)`` with the scales folded in
    (``quant_forward.int8_qweights``, the dense forward's fold), for every
    device of the mesh (keyed by ``str(device)``)."""

    def __init__(self, scales, qweights):
        self.scales = scales
        self.qweights = qweights


class _QCalibCtx:
    """Calibration: the plain forward, recording each site's per-channel
    max |x| on each shard; the max over the shards and data groups is
    taken after the forward (``all_max``), the dense max over the batch."""

    def __init__(self):
        self.amax: Dict[str, list] = {}


class _QCtx:
    """Quantization-aware training on row blocks, the twin of
    ``models/quant_forward``'s ``fakequant`` mode: ``scales[site]`` holds
    the site's per-Cin activation scale on each block's device (the
    dense fakequant forward's site names), ``fg_mask`` each block's
    (b, 1, 1, 1) foreground routing mask, the same on every shard of a
    sample (its fraction is summed over the space group first), and
    ``amax[site]`` each block's per-channel max |x| over the quantizing
    samples, combined over the world after the forward."""

    def __init__(self, scales, fg_mask):
        self.scales = scales
        self.fg_mask = fg_mask
        self.amax: Dict[str, list] = {}


def _fq(group, qctx: _QCtx, site: str, xs, ws):
    """Fake-quantize a site's input blocks and weights
    (``quant_forward._fakequant``: STE gradients, foreground-routed
    inputs, the masked statistic recorded). Quantization is elementwise
    with replicated scales, so quantizing before the halo exchange equals
    the dense path's quantize of the whole rows: the neighbours' halo
    rows arrive quantized by the same map."""
    def one(x, w, s_a, mask):
        ax = torch.where(mask, x.detach().float().abs(), 0.0)
        xq = torch.where(mask, ste(x, fake_quant_act(x, s_a)), x)
        return xq, ste(w, fake_quant_kernel(w, s_a)), ax.amax(dim=(0, 2, 3))
    res = group.map(one, xs, ws, qctx.scales[site], qctx.fg_mask)
    qctx.amax[site] = [r[2] for r in res]
    return [r[0] for r in res], [r[1] for r in res]


def _site_conv(group, qctx, site, xs, ws, dtype, bs=None, slope=1.0):
    """One quantizable conv site on row blocks, in any mode. ``xs`` is
    the site's input before its activation: LeakyReLU(``slope``), the
    identity at 1.0.

    - plain (``qctx`` None) and calibration: the activation, then the
      halo'd conv; calibration also records the input's per-channel max
      |x| on each shard;
    - QAT (:class:`_QCtx`): the activation, the fake-quantized input and
      weights (:func:`_fq`), then the halo'd conv;
    - int8 serving: B4 quantizes the local rows (the activation folded
      in), the s8 halos are exchanged, the columns zero-padded, and the
      s8 x s8 -> s32 conv dequantizes to the block's dtype.
    """
    if isinstance(qctx, _QServeCtx):
        kh, kw = ws[0].shape[2], ws[0].shape[3]

        def quantize(x):
            return leaky_quantize(x.contiguous(memory_format=CL),
                                  qctx.scales[str(x.device)][site], slope)

        qs = group.halo(group.map(quantize, xs), kh // 2, kh // 2)

        def conv(q, x, b):
            qk, k_scale = qctx.qweights[str(q.device)][site]
            if kw > 1:
                q = F.pad(q, (kw // 2, kw // 2)).contiguous(
                    memory_format=CL)
            return int8_conv(q, qk, k_scale, bias=b, out_dtype=x.dtype)
        return group.map(conv, qs, xs, bs or _none(group))
    if slope != 1.0:
        xs = group.map(lambda x: F.leaky_relu(x, slope), xs)
    if isinstance(qctx, _QCalibCtx):
        qctx.amax[site] = group.map(
            lambda x: x.abs().amax(dim=(0, 2, 3)).float(), xs)
    elif isinstance(qctx, _QCtx) and site in qctx.scales:
        xs, ws = _fq(group, qctx, site, xs, ws)
    return _conv(group, xs, ws, dtype, bs)


# ------------------------------------------------------- model blocks

def _double_conv(group, qctx, P, site, prefix, xs, dtype):
    """DoubleConv: conv -> GN + leaky -> conv -> GN + leaky, plus the
    input when the channels match. The first leaky belongs to conv2's
    site (B4's slope in int8)."""
    p = f"{prefix}.double_conv"
    y = _site_conv(group, qctx, f"{site}.conv1", xs, P(f"{p}.0.weight"),
                   dtype)
    y = _group_norm(group, y, P(f"{p}.1.weight"), P(f"{p}.1.bias"))
    y = _site_conv(group, qctx, f"{site}.conv2", y, P(f"{p}.3.weight"),
                   dtype, slope=_SLOPE)
    res = xs if xs[0].shape[1] == y[0].shape[1] else None
    return _group_norm(group, y, P(f"{p}.4.weight"), P(f"{p}.4.bias"),
                       slope=_SLOPE, residual=res)


def _pool(group, xs):
    return group.map(lambda x: max_pool2(x).contiguous(memory_format=CL), xs)


def _up_block(group, ops, qctx, P, i, x1, x2, dtype):
    """Up: the 1x1 up_conv BEFORE the 2x upsample (``models/unet.Up``),
    GN + leaky, the skip concat, DoubleConv. The shape checks make the
    dense pad-to-match a no-op."""
    y = _site_conv(group, qctx, f"up{i}.up_conv", x1,
                   P(f"up{i}.up.1.weight"), dtype)
    y = _upsample2x(group, ops, y)
    y = _group_norm(group, y, P(f"up{i}.up.2.weight"),
                    P(f"up{i}.up.2.bias"), slope=_SLOPE)
    if y[0].shape[2:] != x2[0].shape[2:]:
        raise AssertionError("the spatial forward needs H % (8*n_space) == "
                             "0 and W % 8 == 0, so that Up blocks never "
                             "pad to match")
    x = group.map(lambda a, b: torch.cat([a, b], dim=1).contiguous(
        memory_format=CL), x2, y)
    return _double_conv(group, qctx, P, f"up{i}.conv", f"up{i}.conv", x,
                        dtype)


def _input_blocks(group, xs, dtype):
    """(b, hl, W, 1) input blocks -> NCHW-indexed channels_last in
    ``dtype``."""
    return group.map(lambda x: x.permute(0, 3, 1, 2).to(dtype).contiguous(
        memory_format=CL), xs)


def _maybe_ckpt(fn, remat: bool):
    """``fn`` recomputed in the backward (``torch.utils.checkpoint``) when
    ``remat`` is on: the recompute re-runs the block's halos and sums,
    the same calls in the same order on every shard, so the tape holds
    only block boundaries (the JAX forward's ``jax.checkpoint``
    segments)."""
    if not remat:
        return fn

    def run(*args):
        return torch.utils.checkpoint.checkpoint(
            fn, *args, use_reentrant=False, preserve_rng_state=False)
    return run


def _backbone(group, ops, qctx, P, xs, dtype, remat=False):
    """The unet/unet_tpu encoder-decoder (``models/unet.backbone``), each
    DoubleConv and Up block a remat segment under ``remat`` (never with a
    QAT context, whose statistics a recompute would record again)."""
    assert qctx is None or not remat
    dc, ub = _maybe_ckpt(_double_conv, remat), _maybe_ckpt(_up_block, remat)
    x1 = dc(group, qctx, P, "inc", "inc", _input_blocks(group, xs, dtype),
            dtype)
    x2 = dc(group, qctx, P, "down1", "down1.maxpool_conv.1",
            _pool(group, x1), dtype)
    x3 = dc(group, qctx, P, "down2", "down2.maxpool_conv.1",
            _pool(group, x2), dtype)
    x4 = dc(group, qctx, P, "down3", "down3.maxpool_conv.1",
            _pool(group, x3), dtype)
    y = ub(group, ops, qctx, P, 1, x4, x3, dtype)
    y = ub(group, ops, qctx, P, 2, y, x2, dtype)
    return ub(group, ops, qctx, P, 3, y, x1, dtype)


def _mix(group, P, a, b, dtype):
    """``w * a + (1 - w) * b`` with ``w = sigmoid(alpha)`` in ``dtype``."""
    def one(x, y, alpha):
        w = torch.sigmoid(alpha).to(dtype).reshape(())
        return (w * x + (1.0 - w) * y).contiguous(memory_format=CL)
    return group.map(one, a, b, P("alpha"))


def _shuffle(group, ys):
    return group.map(lambda y: pixel_shuffle(y, 2).contiguous(
        memory_format=CL), ys)


def _output(group, ys):
    """Sigmoid in fp32, NHWC: each shard's (b, 2hl, 2W, 1) output rows."""
    return group.map(lambda y: torch.sigmoid(y.float()).permute(0, 2, 3, 1),
                     ys)


def _local_forward_unet(group, ops, qctx, P, xs, dtype, remat=False):
    """``UNetSuperRes.forward`` on row blocks (``models/unet.py``): the
    bilinear branch's and the head's narrow convs on kernel B3, except in
    int8 and QAT, where they are quantized sites. Under ``remat`` the two
    branches and the head are segments too."""
    y = _backbone(group, ops, qctx, P, xs, dtype, remat)

    def narrow(site, t, ws):
        if qctx is None:
            return _narrow_conv(group, t, ws, dtype)
        return _site_conv(group, qctx, site, t, ws, dtype)

    def bilinear(y):
        yb = narrow("final_up_conv", _upsample2x(group, ops, y),
                    P("final_up_bilinear.1.weight"))
        return _group_norm(group, yb, P("final_up_bilinear.2.weight"),
                           P("final_up_bilinear.2.bias"), slope=_SLOPE)

    def shuffle(y):
        yp = _site_conv(group, qctx, "final_up_pixelshuffle.conv", y,
                        P("final_up_pixelshuffle.conv.weight"), dtype,
                        P("final_up_pixelshuffle.conv.bias"))
        return _group_norm(group, _shuffle(group, yp),
                           P("final_up_pixelshuffle.norm.weight"),
                           P("final_up_pixelshuffle.norm.bias"), slope=_SLOPE)

    def head(y):
        z = narrow("final_conv1", y, P("final_conv.0.weight"))
        z = _group_norm(group, z, P("final_conv.1.weight"),
                        P("final_conv.1.bias"), slope=_SLOPE)
        # the output head stays in the serving dtype in every mode
        return _conv(group, z, P("final_conv.3.weight"), dtype,
                     P("final_conv.3.bias"))

    yb = _maybe_ckpt(bilinear, remat)(y)
    yp = _maybe_ckpt(shuffle, remat)(y)
    z = _maybe_ckpt(head, remat)(_mix(group, P, yb, yp, dtype))
    return _output(group, z)


def _local_forward_unet_tpu(group, ops, qctx, P, xs, dtype, remat=False):
    """``UNetSuperResTPU.forward`` on row blocks (``models/unet_tpu.py``):
    the final stage at the input resolution, local but for its GroupNorm
    sums and 3x3 halos, then one depth-to-space. Under ``remat`` the two
    branches and the head are segments too."""
    y = _backbone(group, ops, qctx, P, xs, dtype, remat)

    def branch(name, t, bias=None):
        z = _site_conv(group, qctx, f"{name}_conv", t,
                       P(f"{name}_conv.weight"), dtype, bias)
        return _group_norm(group, z, P(f"{name}_norm.weight"),
                           P(f"{name}_norm.bias"), slope=_SLOPE)

    def head(t):
        z = branch("head", t)
        return _conv(group, z, P("head_out.weight"), dtype,
                     P("head_out.bias"))

    a = _maybe_ckpt(branch, remat)("branch_a", y)
    b = _maybe_ckpt(branch, remat)("branch_b", y, P("branch_b_conv.bias"))
    z = _maybe_ckpt(head, remat)(_mix(group, P, a, b, dtype))
    return _output(group, _shuffle(group, z))


def _local_forward_edsr(group, ops, qctx, P, xs, dtype, remat=False):
    """``EDSR.forward`` on row blocks (``models/edsr.py``): a trunk at the
    input resolution whose only collectives are its 3x3 halos; the
    depth-to-space doubles rows within the shard. ``res_scale`` is 1.
    Under ``remat`` each residual block is a segment."""
    def conv(name, t):
        return _site_conv(group, qctx, name, t, P(f"{name}.weight"), dtype,
                          P(f"{name}.bias"))

    def block(i, y):
        z = group.map(F.relu, conv(f"block{i}.conv0", y))
        return group.map(lambda a, b: a + 1.0 * b, y,
                         conv(f"block{i}.conv1", z))

    head = conv("head", _input_blocks(group, xs, dtype))
    y = head
    for i in range(P.num_blocks):
        y = _maybe_ckpt(block, remat)(i, y)
    y = group.map(torch.add, conv("body_out", y), head)
    y = _conv(group, y, P("tail.weight"), dtype, P("tail.bias"))
    return _output(group, _shuffle(group, y))


def _local_forward_simple(group, ops, qctx, P, xs, dtype, remat=False):
    """``SimpleSR.forward`` on row blocks (``models/simple.py``): the
    9-5-5 trunk takes 4-, 2- and 2-row halos; the rest is local."""
    def conv(name, t):
        return _site_conv(group, qctx, name, t, P(f"{name}.weight"), dtype,
                          P(f"{name}.bias"))

    y = group.map(F.relu, conv("extract", _input_blocks(group, xs, dtype)))
    y = group.map(F.relu, conv("map", y))
    y = _conv(group, y, P("reconstruct.weight"), dtype,
              P("reconstruct.bias"))
    return _output(group, _shuffle(group, y))


_LOCAL_FORWARDS = {"unet": _local_forward_unet,
                   "unet_tpu": _local_forward_unet_tpu,
                   "edsr": _local_forward_edsr,
                   "simple": _local_forward_simple}


def supported_types():
    """The model types with a row-sharded forward."""
    return sorted(_LOCAL_FORWARDS)


class _Params:
    """``P(key)``: a parameter's tensor on each shard of a group, from one
    state_dict a shard."""

    def __init__(self, sds: list):
        self._sds = sds
        from mri_superresolution_torch.utils.weights import edsr_num_blocks
        self.num_blocks = (edsr_num_blocks(sds[0])
                           if "head.weight" in sds[0] else 0)

    def __call__(self, key: str) -> list:
        return [sd[key] for sd in self._sds]


def _shard_params(params, mesh: SpatialMesh) -> list:
    """One state_dict a device of ``mesh`` (data-major): ``params`` when
    it is a list of them, else one state_dict read on every device (a copy
    only where a tensor lies elsewhere)."""
    devs = mesh.devices
    if isinstance(params, (list, tuple)):
        if len(params) != len(devs):
            raise ValueError(f"{len(params)} state_dicts for a mesh of "
                             f"{len(devs)} devices")
        return list(params)
    return [{k: v.to(d) for k, v in params.items()} for d in devs]


def _per_device(mesh: SpatialMesh, tensors: dict) -> dict:
    """``{str(device): tensors}`` for each distinct device of ``mesh``, the
    values (tensors or tuples of them) moved there once."""
    def move(v, d):
        if isinstance(v, tuple):
            return tuple(t.to(d) for t in v)
        return v.to(d)
    return {str(d): {k: move(v, d) for k, v in tensors.items()}
            for d in dict.fromkeys(mesh.devices)}


def _check(model_type: str, input_hw, n_space: int) -> None:
    """ValueError for a family without a row-sharded forward, or an
    (H, W) whose pools or halos would cross more than one shard."""
    if model_type not in _LOCAL_FORWARDS:
        raise ValueError(f"spatial sharding supports model types "
                         f"{sorted(_LOCAL_FORWARDS)}, not {model_type!r}")
    h, w = input_hw
    if h % (8 * n_space) != 0:
        raise ValueError(f"H={h} must be divisible by 8*n_space={8 * n_space}")
    if w % 8 != 0:
        raise ValueError(f"W={w} must be divisible by 8")


def _make_local_forward(mesh: SpatialMesh, input_hw, dtype,
                        model_type: str):
    """Check the shapes and return ``run(params, x, make_ctx) -> (y,
    ctxs)``: the forward of the (B, H, W, 1) batch ``x`` over ``mesh``,
    the batch split over the data groups and the rows over each group's
    devices, ``y`` the (B, 2H, 2W, 1) fp32 output gathered on x's device
    and ``ctxs`` each group's int8 context."""
    n_data, n_space = mesh.shape
    _check(model_type, input_hw, n_space)
    h, w = input_hw
    fwd = _LOCAL_FORWARDS[model_type]
    ops = _Operators(n_space)
    hl = h // n_space

    def run(params, x, make_ctx=lambda: None):
        if tuple(x.shape[1:3]) != (h, w):
            raise ValueError(f"this forward was built for {h}x{w}, got "
                             f"{tuple(x.shape[1:3])}")
        if x.shape[0] % n_data:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{n_data} data groups")
        sds = _shard_params(params, mesh)
        bl = x.shape[0] // n_data
        outs, ctxs = [], []
        for g, group in enumerate(mesh.groups):
            xs = [x[g * bl:(g + 1) * bl, s * hl:(s + 1) * hl].to(d)
                  for s, d in enumerate(group.devices)]
            ctxs.append(make_ctx())
            ys = fwd(group, ops, ctxs[-1],
                     _Params(sds[g * n_space:(g + 1) * n_space]), xs, dtype)
            outs.append(torch.cat([y.to(x.device) for y in ys], dim=1))
        return (torch.cat(outs) if n_data > 1 else outs[0]), ctxs

    return run


# ------------------------------------------------------------ public API

def build_spatial_forward_raw(mesh: SpatialMesh, input_hw,
                              dtype=torch.bfloat16,
                              model_type: str = "unet"):
    """The row-sharded forward of ``model_type`` for a FIXED (H, W) over
    ``mesh``: ``fn(params, x) -> y``, x the (B, H, W, 1) fp32 batch (B a
    multiple of the data groups, H of 8 * n_space, W of 8), y the (B, 2H,
    2W, 1) fp32 output on x's device, the dense forward's to float
    tolerance. ``params`` is the family's state_dict, or one a device of
    the mesh (data-major). Each call runs eagerly, so it also runs inside
    a larger function (the engine's TTA ensemble, a traced artifact)."""
    run = _make_local_forward(mesh, input_hw, dtype, model_type)
    return lambda params, x: run(params, x)[0]


def build_spatial_forward(mesh: SpatialMesh, input_hw,
                          dtype=torch.bfloat16, model_type: str = "unet"):
    """:func:`build_spatial_forward_raw`, run under inference mode."""
    raw = build_spatial_forward_raw(mesh, input_hw, dtype, model_type)

    def fn(params, x):
        with torch.inference_mode():
            return raw(params, x)
    return fn


def build_spatial_int8_forward_raw(mesh: SpatialMesh, input_hw, params,
                                   scales, model_type: str = "unet",
                                   dtype=torch.bfloat16, qweights=None):
    """The row-sharded FROZEN-SCALE int8 forward: ``fn(params, x) -> y``.

    Every site the dense int8 forward quantizes runs as an s8 x s8 -> s32
    conv whose row halos are exchanged AFTER B4's quantize
    (:func:`_site_conv`), with the dense forward's folded int8 weights
    (``quant_forward.int8_qweights``; pass ``qweights`` to reuse them
    across shapes). The output heads and GroupNorms stay in ``dtype``, as
    in the dense int8 forward. The weights and scales are placed on each
    device of the mesh here, once."""
    from mri_superresolution_torch.models import quant_forward
    run = _make_local_forward(mesh, input_hw, dtype, model_type)
    if qweights is None:
        qweights = quant_forward.int8_qweights(
            _shard_params(params, mesh)[0], scales, model_type)
    act = {site: torch.as_tensor(np.asarray(scales[site], np.float32))
           for site in qweights}
    ctx = _QServeCtx(_per_device(mesh, act), _per_device(mesh, qweights))
    return lambda p, x: run(p, x, lambda: ctx)[0]


def build_spatial_calib_forward_raw(mesh: SpatialMesh, input_hw, sites,
                                    model_type: str = "unet",
                                    dtype=torch.bfloat16):
    """The row-sharded CALIBRATION forward: ``fn(params, x) -> (y,
    amax)``, y the plain forward and ``amax`` each quantizable site's
    per-input-channel max |x| over the whole batch (the shards' maxima
    combined by ``all_max`` over each group, then over the data groups),
    fp32 on x's device: the dense ``calib`` statistic, as a max does not
    depend on the order it is taken in.

    ``sites`` is the dense forward's site list
    (``quant_forward.amax_template`` keys); a forward whose sites differ
    raises, which keeps the two enumerations together."""
    run = _make_local_forward(mesh, input_hw, dtype, model_type)
    sites = sorted(sites)

    def fn(params, x):
        y, ctxs = run(params, x, _QCalibCtx)
        amax = {}
        for ctx, group in zip(ctxs, mesh.groups):
            missing = sorted(set(sites) ^ set(ctx.amax))
            if missing:
                raise AssertionError(
                    f"spatial calib sites out of sync with the dense "
                    f"forward's: {missing}")
            for k, v in ctx.amax.items():
                m = group.all_max(v)[0].to(x.device)
                amax[k] = m if k not in amax else torch.maximum(amax[k], m)
        return y, amax

    return fn


# ----------------------------------------------- row-sharded training loss

def _separable_blur_sharded(x: torch.Tensor, window_size: int,
                            sigma: float) -> torch.Tensor:
    """``ops/ssim``'s Gaussian blur of an NCHW block that carries
    ``window_size // 2`` halo rows above and below: the rows are blurred
    without padding (the halo replaces the dense row padding; the edge
    shards' halos are zeros, the dense padding), the columns with the
    dense zero padding, and the halo rows drop out. Shifted fp32 products
    summed tap by tap, so that the value and its gradient stay fp32 on a
    card whose convolutions may take TF32."""
    g = _ssim.gaussian_window(window_size, sigma, x.device)
    pad = window_size // 2
    h, w = x.shape[2] - 2 * pad, x.shape[3]
    y = g[0] * x[:, :, 0:h]
    for k in range(1, window_size):
        y = y + g[k] * x[:, :, k:k + h]
    y = F.pad(y, (pad, pad))
    out = g[0] * y[:, :, :, 0:w]
    for k in range(1, window_size):
        out = out + g[k] * y[:, :, :, k:k + w]
    return out


def _rows_halo(group, xs, p: int) -> list:
    """NHWC blocks extended by ``p`` rows of each neighbour (NHWC)."""
    ext = group.halo(group.map(lambda x: x.permute(0, 3, 1, 2).contiguous(
        memory_format=CL), xs), p, p)
    return group.map(lambda x: x.permute(0, 2, 3, 1), ext)


def _mean_hwc_sharded(group, xs) -> list:
    """Per-sample mean over (global rows, W, C) of NHWC row blocks: local
    fp32 sums, added over the space group."""
    sums = group.all_sum(group.map(lambda x: x.sum(dim=(1, 2, 3)), xs))
    n = xs[0].shape[1] * group.n * xs[0].shape[2] * xs[0].shape[3]
    return group.map(lambda s: s / n, sums)


def _ssim_per_sample_sharded(group, a, b, window_size: int, sigma: float,
                             val_range: float) -> list:
    """Per-sample SSIM of NHWC row blocks: both images take
    ``window_size // 2`` halo rows, ``ops/ssim.ssim_map`` (the one copy of
    the SSIM formula) runs on each haloed block with the unpadded row
    blur (:func:`_separable_blur_sharded`), and the maps' means are
    summed over the group. The halo moves the two images' rows, not the
    five blurred products': they are per-pixel functions of the images,
    so the values are those of a halo of the products."""
    p = window_size // 2

    def one(x, y):
        return _ssim.ssim_map(x, y, window_size, sigma, val_range,
                              blur_fn=lambda t: _separable_blur_sharded(
                                  t, window_size, sigma))
    return _mean_hwc_sharded(group, group.map(
        one, _rows_halo(group, a, p), _rows_halo(group, b, p)))


def _weighted_mean_global(group, pers, ws) -> list:
    """Weighted mean over the GLOBAL batch (``losses/combined.
    _weighted_mean``): the weighted sum and the weight sum added over the
    data group."""
    num = group.data_sum(group.map(
        lambda per, w: (per * w.float()).sum(), pers, ws))
    den = group.data_sum(group.map(lambda w: w.float().sum(), ws))
    return group.map(lambda n, d: n / d.clamp_min(1e-12), num, den)


def _halo_conv3x3_bias(group):
    """VGG's padded 3x3 conv on row blocks: 1-row halos replace the dense
    row padding."""
    def conv(xs, w, b):
        return group.map(lambda x: F.conv2d(x, w, b, padding=(0, 1)),
                         group.halo(xs, 1, 1))
    return conv


def _local_pool2(group):
    """VGG's 2x2 maxpool, shard-local: :func:`build_spatial_loss` checks
    that the stride-2 windows never straddle a shard border."""
    def pool(xs):
        if xs[0].shape[2] % 2 != 0:
            raise ValueError(
                f"sharded VGG pool hit odd local rows ({xs[0].shape[2]}) — "
                "build_spatial_loss validation should have rejected this "
                "config")
        return group.map(lambda x: F.max_pool2d(x, 2), xs)
    return pool


def _vgg_features_sharded(group, vgg, xs) -> list:
    """``models/vgg``'s layer loop (the one copy of the VGG19 stack) on
    row blocks: the 3x3 convs take 1-row halos, the pools and ReLUs are
    shard-local."""
    return vgg(xs, conv_fn=_halo_conv3x3_bias(group),
               pool_fn=_local_pool2(group), each=group.map)


_COMP_KEYS = ("l1_loss", "ssim_loss", "ssim_metric", "perceptual_loss")


def build_spatial_loss(mesh, input_hw, loss_cfg, model_type: str = "unet",
                       dtype=torch.bfloat16, vgg=None, remat: bool = False,
                       qat_sites=None, qat_min_foreground: float = 0.05):
    """The row-sharded forward and ``CombinedLoss`` over a mesh, for
    training: ``loss_fn(params, hr, lr, weights) -> (total, comps, out)``.

    ``mesh`` is a :class:`SpatialMesh` in this process, whose loss takes
    the global (B, 2H, 2W, 1) ``hr``, (B, H, W, 1) ``lr`` and (B,)
    ``weights`` and returns the global ``out``; or this rank's
    :class:`RankMesh`, whose loss takes and returns the rank's row blocks
    (``RankMesh.rows`` of its data group's images) and its data group's
    weights. ``params`` is the family's state_dict; the model's live one
    (``model.state_dict(keep_vars=True)``) lets gradients reach
    ``model.parameters()``. ``total`` and ``comps`` are the global
    batch's, the same bits on every shard: the loss of
    ``losses/combined.compose_loss`` with its sums over the space group
    (per-sample means, the SSIM's haloed blur) and the data group (the
    weighted means, so the SSIM clip is the global mean's); ``comps``
    always holds the four keys of ``_COMP_KEYS`` (zeros for terms without
    a weight). The perceptual term runs VGG19 row-sharded
    (:func:`_vgg_features_sharded`), the target's features without a
    gradient.

    Over ranks, each rank's backward from ``total`` gives its share of
    the gradient: the sums' backwards sum over their groups, so only one
    rank may seed the replicated loss (rank 0 seeds 1, the others 0, as
    the one loss of the in-process mesh is seeded once), and the
    parameters' gradients are then summed over the world
    (``train/trainer.spatial_loss_and_grads``).

    ``remat`` recomputes the forward's blocks in the backward
    (:func:`_maybe_ckpt`) and the whole loss graph (the SSIM blurs, the
    VGG stack and their collectives), as JAX's ``jax.checkpoint`` does.

    ``qat_sites`` (the dense fakequant forward's site names,
    ``quant_forward.amax_template``'s keys) makes it quantization-aware:
    ``loss_fn(params, qat_amax, hr, lr, weights)``, whose comps also
    carry ``qat_batch_amax`` (each site's per-channel max |x| over the
    quantizing samples of the whole batch, a max over the world) and
    ``qat_any_fg``. A sample quantizes when ``qat_min_foreground`` of its
    GLOBAL pixels are foreground (the count summed over the space group
    first), so every shard of a sample routes it alike. The model-side
    remat segments are off under QAT; the loss's checkpoint stays.

    Raises ValueError, with the JAX package's messages, for an even SSIM
    window, a halo deeper than a shard's HR rows, or VGG pools that would
    straddle shards."""
    from mri_superresolution_torch.losses.combined import compose_loss

    loss_cfg.validate()
    if loss_cfg.perceptual_weight > 0 and vgg is None:
        raise ValueError("perceptual_weight > 0 requires vgg")
    n_space = mesh.shape[1]
    _check(model_type, input_hw, n_space)
    h = input_hw[0]
    cfg = loss_cfg
    hr_local_rows = 2 * h // n_space
    # the SSIM blur reaches window//2 rows into each neighbour; a deeper
    # halo would need more than the next shard (and an even window would
    # change the output's row count)
    if cfg.window_size % 2 != 1:
        raise ValueError(f"window_size must be odd for spatial sharding "
                         f"(got {cfg.window_size})")
    if cfg.window_size // 2 > hr_local_rows:
        raise ValueError(
            f"SSIM window {cfg.window_size} needs a {cfg.window_size // 2}-"
            f"row halo but each shard only holds {hr_local_rows} HR rows; "
            f"reduce spatial_shards or window_size")
    if cfg.perceptual_weight > 0:
        from mri_superresolution_torch.models.vgg import n_pools
        pools = n_pools(cfg.vgg_layer_idx)
        if hr_local_rows % (2 ** pools) != 0:
            raise ValueError(
                f"sharded VGG perceptual loss crosses {pools} 2x2 pools, "
                f"so local HR rows ({hr_local_rows} = 2*{h}/{n_space}) must "
                f"be divisible by {2 ** pools}; use a conforming H / "
                f"spatial_shards or a smaller vgg_layer_idx")
    qat_on = qat_sites is not None
    group = mesh.train_group()
    fwd, ops = _LOCAL_FORWARDS[model_type], _Operators(n_space)
    model_remat = remat and not qat_on

    def loss_part(out32, hr32, ws):
        total, comps = compose_loss(
            cfg, out32, hr32, ws, each=group.map,
            per_sample_mean=lambda xs: _mean_hwc_sharded(group, xs),
            weighted_mean=lambda pers, w: _weighted_mean_global(group, pers,
                                                                w),
            ssim_per_sample=lambda a, b: _ssim_per_sample_sharded(
                group, a, b, cfg.window_size, cfg.sigma, cfg.val_range),
            vgg_features=lambda xs: _vgg_features_sharded(group, vgg, xs),
            always_ssim_metric=True)
        zero = group.map(lambda t: torch.zeros_like(t), total)
        return total, {k: comps.get(k, zero) for k in _COMP_KEYS}

    if remat:
        # the backward re-runs the SSIM blurs and the VGG stack (and
        # their collectives) instead of holding their tape
        part = loss_part

        def loss_part(out32, hr32, ws):
            if not torch.is_grad_enabled():
                return part(out32, hr32, ws)
            return torch.utils.checkpoint.checkpoint(
                part, out32, hr32, ws, use_reentrant=False,
                preserve_rng_state=False)

    def qat_context(qat_amax, los):
        scales = {}
        for k, v in qat_amax.items():
            v = torch.as_tensor(v, dtype=torch.float32)
            v = torch.where(v > 0, v / 127.0, torch.ones_like(v))
            scales[k] = [v.to(d) for d in group.devices]
        # the foreground fraction of each GLOBAL sample: the local counts
        # summed over the space group, so all shards route it together
        cnt = group.all_sum(group.map(
            lambda x: (x.float().abs() > FOREGROUND_INTENSITY).float().sum(
                dim=(1, 2, 3)), los))
        n_px = los[0].shape[1] * n_space * los[0].shape[2] * los[0].shape[3]
        return _QCtx(scales, group.map(
            lambda c: (c / n_px >= qat_min_foreground).reshape(-1, 1, 1, 1),
            cnt))

    def run(params, qat_amax, hr, lo, wts):
        los, hrs = mesh.split(lo), mesh.split(hr)
        ws = mesh.split_weights(wts)
        P = _Params(_shard_params(params, mesh))
        qctx = qat_context(qat_amax, los) if qat_on else None
        out = fwd(group, ops, qctx, P, los, dtype, remat=model_remat)
        total, comps = loss_part(out, group.map(lambda t: t.float(), hrs),
                                 ws)
        comps = {k: v[0] for k, v in comps.items()}
        if qat_on:
            missing = sorted(set(qat_sites) ^ set(qctx.amax))
            if missing:
                raise AssertionError(
                    f"spatial fakequant sites out of sync with the dense "
                    f"forward's: {missing}")
            keys = sorted(qctx.amax)
            sizes = [qctx.amax[k][0].numel() for k in keys]
            flat = group.world_max([torch.cat(
                [qctx.amax[k][i] for k in keys] + [m.any().float().view(1)])
                for i, m in enumerate(qctx.fg_mask)])[0]
            parts = flat.split(sizes + [1])
            comps["qat_batch_amax"] = dict(zip(keys, parts[:-1]))
            comps["qat_any_fg"] = parts[-1][0] > 0
        return total[0], comps, mesh.join(out, lo)

    if qat_on:
        return run
    return lambda params, hr, lo, wts: run(params, None, hr, lo, wts)
