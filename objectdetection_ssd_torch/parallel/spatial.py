"""Spatial partitioning over the ``spatial`` axis of a mesh: what GSPMD
does for the JAX package's ``spatial`` axis (`objectdetection_ssd_tpu/
parallel/mesh.py:spatial_ways`, `image_sharding`), written by hand.

Each rank of a ``spatial`` group of ``ways`` ranks computes its rows of
every feature map, for the whole batch of its data shard; the parameters
are whole on every rank.

**The partition rule.**  Every map of ``H`` rows is cut by
`parallel/mesh.py:row_bounds`: rank ``i`` owns rows ``floor(i * H /
ways)`` to ``floor((i + 1) * H / ways)``.  The input image (``ways``
divides its size) is cut evenly; the smaller maps of SSD300 (75, 38, 19,
10, 5, 3, 1) and ResNet-34 (7, 4, 2, 1) are cut into slices that differ
by at most one row, and a rank may own none of a map with fewer rows than
ranks.  Every map is square (square inputs, symmetric kernels), so a
layer reads the global height ``H`` of its input from its width.

**A layer's rows.**  A conv or pool of kernel ``k``, stride ``s``, padding
``p`` and dilation ``d`` computes output rows ``[a, b)`` from input rows
``[a*s - p, (b-1)*s - p + d*(k-1) + 1)`` of the global grid, so each
rank's first output row lines up with the single-process grid at any
stride.  Rows above 0 or below ``H`` are padding: zeros for a conv (int8
zero for an int8 conv, the same bits), ``-inf`` for a max pool (``-128``
for an int8 one, which never wins), so the ceil-mode pool's last window
sees what it sees in one process, on the last rank only.  The layer then
runs with padding 0 in H and its own padding in W.  A rank that owns no
output rows computes one row it discards, so every rank runs the same
operators — the backward's collectives then come in the same order on
every rank.

**The halo exchange.**  The rows a rank needs from the others can reach
past its neighbours (fc6's dilation 4, the 3x3 VALID extras at 5 -> 3 ->
1 under ``ways`` = 4), so the exchange is not a send to the neighbour:
for each rank, the rows that the ranks above it need form its top band
and the rows the ranks below need its bottom band (a band spans what any
of them needs).  Every rank contributes both bands, zero-padded to the
group's widest, to one `parallel/collectives.py:all_gather_stack`, and
takes what it needs from the stack.  The backward all-reduces the
stack's gradient, which sends each halo row's gradient back to its owner
and adds it there.  A layer whose ranks need no other rank's rows (1x1
convs, aligned 2x2 pools) exchanges nothing.  The plan of each (height,
geometry) is computed once.

**The heads** are gathered along H (`SpatialParallel.whole`) before
`flatten_head`, so the rows come out in the order of `ops/priors.py`.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from objectdetection_ssd_torch.parallel import mesh as mesh_lib
from objectdetection_ssd_torch.parallel.collectives import all_gather_stack

Rows = Tuple[int, int]


def out_size(size: int, kernel: int, stride: int = 1, padding: int = 0,
             dilation: int = 1, ceil_mode: bool = False) -> int:
    """torch's output size of a conv or max pool along one dim."""
    span = size + 2 * padding - dilation * (kernel - 1) - 1
    n = (-(-span // stride) if ceil_mode else span // stride) + 1
    # torch drops a ceil-mode window that starts in the bottom padding.
    if ceil_mode and (n - 1) * stride >= size + padding:
        n -= 1
    return n


def _meet(a: Rows, b: Rows) -> Rows:
    lo, hi = max(a[0], b[0]), min(a[1], b[1])
    return (lo, hi) if hi > lo else (lo, lo)


def _hull(ranges: List[Rows]) -> Rows:
    ranges = [r for r in ranges if r[1] > r[0]]
    if not ranges:
        return (0, 0)
    return min(r[0] for r in ranges), max(r[1] for r in ranges)


class HaloPlan(NamedTuple):
    """One layer's rows on every rank of the group (global row indices)."""
    rows: List[int]         # output rows each rank owns (count)
    own: List[Rows]         # input rows each rank owns
    need: List[Rows]        # input rows each rank's computed rows read
    top: List[Rows]         # each rank's rows that ranks above it read
    bottom: List[Rows]      # each rank's rows that ranks below it read
    widths: Tuple[int, int]  # the widest top and bottom band


def halo_plan(height: int, ways: int, kernel: int, stride: int = 1,
              padding: int = 0, dilation: int = 1,
              ceil_mode: bool = False) -> HaloPlan:
    """The rows of one conv or pool over a map of ``height`` rows, cut by
    `parallel/mesh.py:row_bounds` over ``ways`` ranks."""
    h_out = out_size(height, kernel, stride, padding, dilation, ceil_mode)
    span = dilation * (kernel - 1) + 1
    rows, own, need = [], [], []
    for i in range(ways):
        a, b = mesh_lib.row_bounds(h_out, ways, i)
        rows.append(b - a)
        if b == a:              # no rows: compute one and discard it
            a = min(a, h_out - 1)
            b = a + 1
        own.append(mesh_lib.row_bounds(height, ways, i))
        need.append((a * stride - padding, (b - 1) * stride - padding + span))
    top = [_hull([_meet(need[s], own[j]) for s in range(j)])
           for j in range(ways)]
    bottom = [_hull([_meet(need[s], own[j]) for s in range(j + 1, ways)])
              for j in range(ways)]
    widths = (max(t[1] - t[0] for t in top),
              max(t[1] - t[0] for t in bottom))
    return HaloPlan(rows, own, need, top, bottom, widths)


class _NarrowRows(torch.autograd.Function):
    """``y[:, :, start:start + n]`` whose gradient is ``channels_last``
    (the slice's own backward pads into a contiguous NCHW buffer, which
    the K2 route would copy)."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, start: int, n: int) -> torch.Tensor:
        ctx.shape, ctx.start = y.shape, start
        return y.narrow(2, start, n)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        b, c, h, w = ctx.shape
        out = grad.new_zeros((b, h, w, c)).permute(0, 3, 1, 2)
        out.narrow(2, ctx.start, grad.shape[2]).copy_(grad)
        return out, None, None


def narrow_rows(y: torch.Tensor, start: int, n: int) -> torch.Tensor:
    return _NarrowRows.apply(y, start, n)


class SpatialParallel:
    """A rank's place on the ``spatial`` axis of ``mesh``: the partition
    that the layers of a model consult (``part``)."""

    kind = "spatial"

    def __init__(self, mesh: DeviceMesh):
        self.group = mesh.get_group("spatial")
        self.ways = mesh_lib.spatial_ways(mesh)
        self.index = mesh.get_local_rank("spatial")
        self._plans: Dict[tuple, HaloPlan] = {}

    narrow_rows = staticmethod(narrow_rows)

    def full_channels(self, x: torch.Tensor, channels: int) -> torch.Tensor:
        """Every channel is whole under spatial partitioning."""
        return x

    def rows(self, height: int) -> Rows:
        """``[lo, hi)``: this rank's rows of a map of ``height`` rows."""
        return mesh_lib.row_bounds(height, self.ways, self.index)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The model's input (B, C, S, S) -> this rank's rows of it."""
        lo, hi = self.rows(x.shape[2])
        return x[:, :, lo:hi]

    def plan(self, height: int, kernel: int, stride: int = 1,
             padding: int = 0, dilation: int = 1,
             ceil_mode: bool = False) -> HaloPlan:
        key = (height, kernel, stride, padding, dilation, ceil_mode)
        if key not in self._plans:
            self._plans[key] = halo_plan(height, self.ways, *key[1:])
        return self._plans[key]

    def extend(self, x: torch.Tensor, kernel: int, stride: int = 1,
               padding: int = 0, dilation: int = 1, ceil_mode: bool = False,
               fill: float = 0.0, pad_w: int = 0
               ) -> Tuple[torch.Tensor, int]:
        """This rank's rows ``x`` (B, C, h, W) of a map of W rows ->
        (the input rows its output rows read, ``fill`` outside the map and
        ``pad_w`` zero columns each side; the number of output rows it
        owns).  The layer runs on the first with padding 0 in H and keeps
        that many of its rows (`narrow_rows`)."""
        p = self.plan(x.shape[3], kernel, stride, padding, dilation,
                      ceil_mode)
        r = self.index
        xh = x.permute(0, 2, 3, 1)                      # (B, h, W, C)
        base = p.own[r][0]
        kt, kb = p.widths

        def own_rows(rows: Rows) -> torch.Tensor:
            return xh[:, rows[0] - base:rows[1] - base]

        def filled(n: int, value: float) -> torch.Tensor:
            return xh.new_full((xh.shape[0], n) + xh.shape[2:], value)

        stack = None
        if kt or kb:
            top, bottom = p.top[r], p.bottom[r]
            band = torch.cat([
                own_rows(top), filled(kt - (top[1] - top[0]), 0),
                own_rows(bottom), filled(kb - (bottom[1] - bottom[0]), 0)],
                dim=1)
            stack = all_gather_stack(band, self.group)
        lo, hi = p.need[r]
        height = x.shape[3]
        pieces = [filled(max(0, min(hi, 0) - lo), fill)]
        for j in range(self.ways):
            got = _meet((lo, hi), p.own[j])
            if j == r:
                pieces.append(own_rows(got))
            elif stack is not None:
                # The ranks above read a rank's top band, those below its
                # bottom band; both hold every row they read.
                t0 = p.top[j][0] if j > r else p.bottom[j][0] - kt
                pieces.append(stack[j][:, got[0] - t0:got[1] - t0]
                              if got[1] > got[0] else stack[j][:, :0])
            elif got[1] > got[0]:
                raise AssertionError("halo plan without an exchange reads "
                                     "another rank's rows")
        pieces.append(filled(max(0, hi - max(lo, height)), fill))
        if stack is not None:
            # Every rank reads the stack, so every rank's backward meets
            # the stack's all-reduce.
            pieces.append(stack[r][:, :0])
        ext = torch.cat(pieces, dim=1)
        if pad_w:
            cols = ext.new_zeros(ext.shape[:2] + (pad_w, ext.shape[3]))
            ext = torch.cat([cols, ext, cols], dim=2)
        return ext.permute(0, 3, 1, 2), p.rows[r]

    def whole(self, x: torch.Tensor, channels: Optional[int] = None
              ) -> torch.Tensor:
        """This rank's rows (B, C, h, W) of a map of W rows -> the whole map
        (B, C, W, W), every rank's rows in order (differentiable).
        ``channels`` is unused: the rows are what is cut."""
        del channels
        height = x.shape[3]
        widest = max(b - a for a, b in (mesh_lib.row_bounds(
            height, self.ways, j) for j in range(self.ways)))
        xh = x.permute(0, 2, 3, 1)
        pad = xh.new_zeros((xh.shape[0], widest - xh.shape[1])
                           + xh.shape[2:])
        stack = all_gather_stack(torch.cat([xh, pad], dim=1), self.group)
        parts = []
        for j in range(self.ways):
            a, b = mesh_lib.row_bounds(height, self.ways, j)
            parts.append(stack[j][:, :b - a])
        return torch.cat(parts, dim=1).permute(0, 3, 1, 2)
