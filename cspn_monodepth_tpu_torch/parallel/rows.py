"""Feature maps sharded over H on a mesh's "spatial" axis (the "rows"
layout; counterpart of the JAX package's GSPMD sharding of every feature
map over "spatial", cspn_monodepth_tpu/parallel/mesh.py).

Rank s of a spatial group of S ranks holds, of every image of its data
group, the rows `row_range(height, S, s)` of each level: ceil(H_l / S) rows
a rank, the last rank the remainder, each level partitioned from its own
global height H_l. A level on which some rank would hold no rows is
refused (`Rows`).

The operations take and give this rank's rows:
* `fetch_rows` gathers any window of global rows from whichever ranks hold
  them, in one `all_to_all_v` of the spatial group (none where every window
  lies in its own rank's rows), with `fill` outside the image;
* `conv2d_rows` computes a conv's output rows [o0, o1) from input rows
  [o0 st - p, (o1 - 1) st - p + k), with H padding 0 (the window carries
  the zero border) and the conv's W padding;
* `max_pool_rows` likewise, with -inf as the border, as the JAX max pool
  pads;
* `unpool_cat_rows` builds the window of a decoder block's 5x5 convs:
  unpooled row j is input row j // 2, and the skip is zero past its height.

Every one of them is differentiable: the backward of an exchange sends
each row's cotangent back to the rank that holds the row.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from cspn_monodepth_tpu_torch.parallel.comm import all_to_all_v


def row_range(height: int, spatial: int, s: int) -> tuple[int, int]:
    """Global rows [lo, hi) that spatial rank s holds of a level of
    `height` rows: ceil(height / spatial) each, the last the remainder."""
    per = -(-height // spatial)
    lo = min(s * per, height)
    return lo, min(lo + per, height)


@dataclasses.dataclass(frozen=True)
class Rows:
    """The layout of one level: `height` global rows split over the
    spatial axis of `mesh` (a parallel.Mesh) by row_range. Refuses, naming
    the level, a height at which some rank would hold no rows."""

    mesh: object
    height: int
    level: str = ""

    def __post_init__(self):
        n = self.mesh.spatial
        lo, hi = row_range(self.height, n, n - 1)
        if hi <= lo:
            raise ValueError(
                f"level {self.level or '?'} of {self.height} rows leaves a "
                f"rank of spatial {n} without rows "
                f"({-(-self.height // n)} a rank)")

    @property
    def range(self) -> tuple[int, int]:
        return row_range(self.height, self.mesh.spatial, self.mesh.s)

    def ranges(self) -> list[tuple[int, int]]:
        return [row_range(self.height, self.mesh.spatial, s)
                for s in range(self.mesh.spatial)]

    def down(self, stride: int, level: str = "") -> "Rows":
        """The layout after a "same"-padded op of this stride (every strided
        op of the network: ceil(height / stride) rows)."""
        return Rows(self.mesh, -(-self.height // stride), level)

    def at(self, height: int) -> "Rows":
        return Rows(self.mesh, height)


def _overlap(a: tuple[int, int], b: tuple[int, int]) -> tuple[int, int]:
    lo = max(a[0], b[0])
    return lo, max(lo, min(a[1], b[1]))


def _framed(pieces: list[torch.Tensor], lo: int, hi: int, height: int,
            fill: float) -> torch.Tensor:
    """The rows [lo, hi): `fill` above row 0 and from row `height` on,
    the pieces (the rows inside [0, height), in order) between."""
    top, bottom = max(0, min(hi, 0) - lo), max(0, hi - max(lo, height))
    x = pieces[0]
    frame = [x.new_full(x.shape[:-2] + (n, x.shape[-1]), fill)
             for n in (top, bottom)]
    return torch.cat([frame[0], *pieces, frame[1]], dim=-2)


def window_rows(x: torch.Tensor, height: int, lo: int, hi: int,
                fill: float = 0.0) -> torch.Tensor:
    """Rows [lo, hi) of x (..., height, W), which holds every row of its
    level, with `fill` outside [0, height)."""
    return _framed([x[..., max(lo, 0):min(hi, height), :]], lo, hi, height,
                   fill)


def fetch_rows(x: torch.Tensor, rows: Rows,
               windows: list[tuple[int, int]], fill: float = 0.0
               ) -> torch.Tensor:
    """Global rows windows[s] of the H-sharded x (b, C, h_s, W), laid out
    as `rows`, to each spatial rank s, with `fill` outside [0, height).
    Every rank of the spatial group calls it with the same windows.
    Differentiable."""
    mesh, height = rows.mesh, rows.height
    parts = rows.ranges()
    me = mesh.s
    lo, hi = windows[me]
    mine = parts[me]
    if x.shape[-2] != mine[1] - mine[0]:
        raise ValueError(f"rank {me} holds rows {mine} of {height}, got "
                         f"{x.shape[-2]} rows")

    def local(a, b):
        return x[..., a - mine[0]:b - mine[0], :]

    remote = any(_overlap(windows[t], parts[u])[1]
                 > _overlap(windows[t], parts[u])[0]
                 for t in range(mesh.spatial) for u in range(mesh.spatial)
                 if t != u)
    if remote:
        send = [_overlap(windows[t], mine) if t != me else (0, 0)
                for t in range(mesh.spatial)]
        recv = [_overlap((lo, hi), parts[u]) if u != me else (0, 0)
                for u in range(mesh.spatial)]
        buf = torch.cat([local(a, b) for a, b in send], dim=-2)
        got = all_to_all_v(buf.movedim(-2, 0), [b - a for a, b in send],
                           [b - a for a, b in recv], mesh.spatial_group)
        received = got.movedim(0, -2).split([b - a for a, b in recv],
                                            dim=-2)
    pieces = [local(*_overlap((lo, hi), mine)) if u == me else received[u]
              for u in range(mesh.spatial) if u == me or remote]
    return _framed(pieces, lo, hi, height, fill)


def _windows(out: Rows, k: int, stride: int, pad: int):
    """Input rows each rank's output rows [o0, o1) read through a k-row
    window of this stride and padding."""
    return [(o0 * stride - pad, (o1 - 1) * stride - pad + k)
            for o0, o1 in out.ranges()]


def conv2d_rows(x: torch.Tensor, conv: nn.Conv2d, rows: Rows,
                whole: bool = False) -> torch.Tensor:
    """conv(x) on rows: this rank's output rows of the conv of the level
    laid out as `rows`. x is this rank's rows, or every row of the level
    (`whole`, the network's input), whose window is then sliced locally."""
    k, st, p = conv.kernel_size[0], conv.stride[0], conv.padding[0]
    out = rows.at((rows.height + 2 * p - k) // st + 1)
    wins = _windows(out, k, st, p)
    if whole:
        xin = window_rows(x, rows.height, *wins[rows.mesh.s])
    else:
        xin = fetch_rows(x, rows, wins)
    return conv2d_window(xin, conv)


def conv2d_window(x: torch.Tensor, conv: nn.Conv2d) -> torch.Tensor:
    """conv on a window of rows: H padding 0 (the window holds the rows
    the outputs read), the conv's own stride and W padding."""
    return F.conv2d(x, conv.weight, conv.bias, conv.stride,
                    (0, conv.padding[1]), conv.dilation, conv.groups)


def conv_on(conv: nn.Conv2d, x: torch.Tensor, rows: Rows | None
            ) -> torch.Tensor:
    """conv(x) on whole images (rows None) or on rows laid out as `rows`."""
    return conv(x) if rows is None else conv2d_rows(x, conv, rows)


def max_pool_rows(x: torch.Tensor, rows: Rows, k: int = 3, stride: int = 2,
                  pad: int = 1) -> torch.Tensor:
    """F.max_pool2d(x, k, stride, pad) on rows, -inf past the border."""
    out = rows.at((rows.height + 2 * pad - k) // stride + 1)
    xin = fetch_rows(x, rows, _windows(out, k, stride, pad), float("-inf"))
    return F.max_pool2d(xin, k, stride, (0, pad))


def unpool_cat_rows(x: torch.Tensor, rows: Rows, out: Rows, halo: int,
                    skip: torch.Tensor | None = None) -> torch.Tensor:
    """The rows [o0 - halo, o1 + halo) of the nearest 2x unpool of x (laid
    out as `rows`), with the skip (laid out as `out`, zero-extended to the
    unpooled width) concatenated along the channels: the window from which
    a (2 halo + 1)-row conv with H padding 0 computes this rank's output
    rows [o0, o1) of `out`. Unpooled row j is row j // 2 of x, zero at or
    past twice x's height; skip rows at or past out.height are zero."""
    o_ranges = out.ranges()
    wins = [((o0 - halo) // 2, (o1 + halo - 1) // 2 + 1)
            for o0, o1 in o_ranges]
    o0, o1 = out.range
    first = 2 * wins[out.mesh.s][0]         # the first unpooled row fetched
    up = F.interpolate(fetch_rows(x, rows, wins), scale_factor=2,
                       mode="nearest")
    up = up[..., o0 - halo - first:o1 + halo - first, :]
    if skip is None:
        return up
    skip = fetch_rows(skip, out, [(lo - halo, hi + halo)
                                  for lo, hi in o_ranges])
    skip = F.pad(skip, (0, up.shape[-1] - skip.shape[-1]))
    return torch.cat([up, skip.to(up.dtype)], dim=1)

