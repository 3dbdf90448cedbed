"""Row-sharded (spatial) serving forwards of the four model families.

The port of the serving half of the JAX package's ``parallel/spatial.py``.
A slice's ROW axis is split over the ``n_space`` devices of a space group,
and the forward runs on the row blocks with explicit collectives:

- a kxk conv takes ``(k//2)``-row halos from its neighbours
  (:meth:`SpaceGroup.halo`); the two edge shards get zero rows, which is
  the dense conv's zero padding, and the columns pad locally;
- GroupNorm statistics are whole-image: local fp32 sums are added over
  the group (:meth:`SpaceGroup.all_sum`), in shard order and once, so that
  every shard normalizes with the same bits;
- the align_corners bilinear 2x row upsample is position-dependent: each
  shard applies its own slice of the global upsample matrix to a 1-row
  haloed block (:func:`_upsample_rows_matrices`);
- max-pool, pixel-shuffle, the blends and the column work are local.

A :class:`SpatialMesh` is a (n_data, n_space) grid over a device pool:
the batch splits over its rows (data groups), a slice's rows over the
devices of a row (a space group). The group here is in-process: the row
blocks of one batch chunk are a list of tensors, one per device, every
block function takes and returns such lists, and a halo is a copy of the
neighbour's edge rows onto this shard's device. The block functions only
call the group's ``halo``, ``all_sum``, ``all_max`` and ``map``, so a
group whose collectives run over a process group plugs in unchanged.

Kernels on the shard path:

- B3 (``kernels.conv3x3``) at the unet's ``final_up_conv`` and
  ``final_conv1``: it runs on the 1-row haloed block, pads all four sides
  with zeros itself, and the first and last of its output rows are
  cropped; the rows left are the dense kernel's on the same input rows.
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
  torch ops on fp32 sums, as JAX's are ``jnp`` plus a ``psum``.

Launches a forward of one chunk over n shards: unet B3 2n in bf16 and
fp32 (none in int8); int8 B4 one per quantized site and shard (unet and
unet_tpu 20n, edsr 18n with 8 blocks, simple 2n); B1 and ``gn_quantize``
none.

Constraints (checked when a forward is built): H % (8 * n_space) == 0 and
W % 8 == 0, so the three pools stay shard-local and every halo comes from
the next shard alone. Parameters are the port's state_dict of the family,
the dense model's, so every checkpoint serves.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mri_superresolution_torch.kernels import conv3x3, leaky_quantize
from mri_superresolution_torch.ops.functional import (GN_EPS, max_pool2,
                                                      pixel_shuffle)
from mri_superresolution_torch.ops.quant import int8_conv
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
    """The collectives of one space group: the n_space devices whose row
    blocks make up one batch chunk, in row order, in this process.

    ``halo``, ``all_sum`` and ``all_max`` take a list of per-shard tensors
    (shard i on ``devices[i]``) and return one. Nothing is written in
    place: on a device named twice, a received halo or a summed
    statistic is a view of another shard's tensor."""

    def __init__(self, devices: Sequence):
        self.devices = [torch.device(d) for d in devices]
        self.n = len(self.devices)

    def map(self, fn, *lists) -> list:
        """``[fn(a_i, b_i, ...)]`` over the shards, each under its own
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
            parts = []
            if up:
                parts.append(xs[i - 1][:, :, -up:].to(x.device) if i > 0
                             else x.new_zeros((b, c, up, w)))
            parts.append(x)
            if down:
                parts.append(xs[i + 1][:, :, :down].to(x.device)
                             if i < self.n - 1
                             else x.new_zeros((b, c, down, w)))
            out.append(torch.cat(parts, dim=2).contiguous(memory_format=CL))
        return out

    def _reduce(self, ts, op) -> list:
        total = ts[0]
        for t in ts[1:]:
            total = op(total, t.to(total.device))
        # one result, handed to every shard: the same bits everywhere
        return [total.to(d) for d in self.devices]

    def all_sum(self, ts: List[torch.Tensor]) -> list:
        """The sum of the shards' tensors in shard order, once, on every
        shard's device."""
        return self._reduce(ts, torch.add)

    def all_max(self, ts: List[torch.Tensor]) -> list:
        return self._reduce(ts, torch.maximum)


class SpatialMesh:
    """A (n_data, n_space) grid of devices: ``grid[g]`` is data group g's
    space group, its devices in row order."""

    def __init__(self, grid: Sequence[Sequence]):
        self.grid = [[torch.device(d) for d in row] for row in grid]
        if not self.grid or len({len(r) for r in self.grid}) != 1:
            raise ValueError("a spatial mesh needs equal, non-empty rows")
        self.shape = (len(self.grid), len(self.grid[0]))
        self.groups = [SpaceGroup(row) for row in self.grid]

    @property
    def devices(self) -> list:
        return [d for row in self.grid for d in row]

    def row(self, g: int) -> "SpatialMesh":
        """Data group ``g`` alone, as a mesh of one row."""
        return SpatialMesh([self.grid[g]])


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
    return [None] * group.n


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
    return group.map(one, range(group.n), xs)


# ------------------------------------------------------- int8 contexts

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


def _site_conv(group, qctx, site, xs, ws, dtype, bs=None, slope=1.0):
    """One quantizable conv site on row blocks, in any mode. ``xs`` is
    the site's input before its activation: LeakyReLU(``slope``), the
    identity at 1.0.

    - plain (``qctx`` None) and calibration: the activation, then the
      halo'd conv; calibration also records the input's per-channel max
      |x| on each shard;
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


def _backbone(group, ops, qctx, P, xs, dtype):
    """The unet/unet_tpu encoder-decoder (``models/unet.backbone``)."""
    x1 = _double_conv(group, qctx, P, "inc", "inc",
                      _input_blocks(group, xs, dtype), dtype)
    x2 = _double_conv(group, qctx, P, "down1", "down1.maxpool_conv.1",
                      _pool(group, x1), dtype)
    x3 = _double_conv(group, qctx, P, "down2", "down2.maxpool_conv.1",
                      _pool(group, x2), dtype)
    x4 = _double_conv(group, qctx, P, "down3", "down3.maxpool_conv.1",
                      _pool(group, x3), dtype)
    y = _up_block(group, ops, qctx, P, 1, x4, x3, dtype)
    y = _up_block(group, ops, qctx, P, 2, y, x2, dtype)
    return _up_block(group, ops, qctx, P, 3, y, x1, dtype)


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


def _local_forward_unet(group, ops, qctx, P, xs, dtype):
    """``UNetSuperRes.forward`` on row blocks (``models/unet.py``): the
    bilinear branch's and the head's narrow convs on kernel B3, except in
    int8, where they are quantized sites."""
    y = _backbone(group, ops, qctx, P, xs, dtype)

    def narrow(site, t, ws):
        if qctx is None:
            return _narrow_conv(group, t, ws, dtype)
        return _site_conv(group, qctx, site, t, ws, dtype)

    yb = narrow("final_up_conv", _upsample2x(group, ops, y),
                P("final_up_bilinear.1.weight"))
    yb = _group_norm(group, yb, P("final_up_bilinear.2.weight"),
                     P("final_up_bilinear.2.bias"), slope=_SLOPE)
    yp = _site_conv(group, qctx, "final_up_pixelshuffle.conv", y,
                    P("final_up_pixelshuffle.conv.weight"), dtype,
                    P("final_up_pixelshuffle.conv.bias"))
    yp = _group_norm(group, _shuffle(group, yp),
                     P("final_up_pixelshuffle.norm.weight"),
                     P("final_up_pixelshuffle.norm.bias"), slope=_SLOPE)
    z = narrow("final_conv1", _mix(group, P, yb, yp, dtype),
               P("final_conv.0.weight"))
    z = _group_norm(group, z, P("final_conv.1.weight"),
                    P("final_conv.1.bias"), slope=_SLOPE)
    # the output head stays in the serving dtype in every mode
    z = _conv(group, z, P("final_conv.3.weight"), dtype,
              P("final_conv.3.bias"))
    return _output(group, z)


def _local_forward_unet_tpu(group, ops, qctx, P, xs, dtype):
    """``UNetSuperResTPU.forward`` on row blocks (``models/unet_tpu.py``):
    the final stage at the input resolution, local but for its GroupNorm
    sums and 3x3 halos, then one depth-to-space."""
    y = _backbone(group, ops, qctx, P, xs, dtype)

    def branch(name, t, bias=None):
        z = _site_conv(group, qctx, f"{name}_conv", t,
                       P(f"{name}_conv.weight"), dtype, bias)
        return _group_norm(group, z, P(f"{name}_norm.weight"),
                           P(f"{name}_norm.bias"), slope=_SLOPE)

    a = branch("branch_a", y)
    b = branch("branch_b", y, P("branch_b_conv.bias"))
    z = branch("head", _mix(group, P, a, b, dtype))
    z = _conv(group, z, P("head_out.weight"), dtype, P("head_out.bias"))
    return _output(group, _shuffle(group, z))


def _local_forward_edsr(group, ops, qctx, P, xs, dtype):
    """``EDSR.forward`` on row blocks (``models/edsr.py``): a trunk at the
    input resolution whose only collectives are its 3x3 halos; the
    depth-to-space doubles rows within the shard. ``res_scale`` is 1."""
    def conv(name, t):
        return _site_conv(group, qctx, name, t, P(f"{name}.weight"), dtype,
                          P(f"{name}.bias"))

    head = conv("head", _input_blocks(group, xs, dtype))
    y = head
    for i in range(P.num_blocks):
        z = group.map(F.relu, conv(f"block{i}.conv0", y))
        y = group.map(lambda a, b: a + 1.0 * b, y,
                      conv(f"block{i}.conv1", z))
    y = group.map(torch.add, conv("body_out", y), head)
    y = _conv(group, y, P("tail.weight"), dtype, P("tail.bias"))
    return _output(group, _shuffle(group, y))


def _local_forward_simple(group, ops, qctx, P, xs, dtype):
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


def _make_local_forward(mesh: SpatialMesh, input_hw, dtype,
                        model_type: str):
    """Check the shapes and return ``run(params, x, make_ctx) -> (y,
    ctxs)``: the forward of the (B, H, W, 1) batch ``x`` over ``mesh``,
    the batch split over the data groups and the rows over each group's
    devices, ``y`` the (B, 2H, 2W, 1) fp32 output gathered on x's device
    and ``ctxs`` each group's int8 context."""
    if model_type not in _LOCAL_FORWARDS:
        raise ValueError(f"spatial sharding supports model types "
                         f"{sorted(_LOCAL_FORWARDS)}, not {model_type!r}")
    h, w = input_hw
    n_data, n_space = mesh.shape
    if h % (8 * n_space) != 0:
        raise ValueError(f"H={h} must be divisible by 8*n_space={8 * n_space}")
    if w % 8 != 0:
        raise ValueError(f"W={w} must be divisible by 8")
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
