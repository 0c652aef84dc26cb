"""Bilinear resampling: grid-sample, cubemap fetch and resize (counterpart of
diffusionrenderer_tpu/ops/resample.py).

Plain torch on the tensors' own device: the JAX package left these gathers
to XLA (no Pallas kernel), and at the forward renderer's sizes (a 6 x 512 x
512 cubemap, one query per output pixel) they are far from the DiT's cost.
Gather indices are int64 on the tensor's device.

* `grid_sample_bilinear` - torch's F.grid_sample(mode='bilinear',
  padding_mode='border', align_corners=False) convention on (H, W, C);
* `sample_cubemap` - the fetch along directions that nvdiffrast's
  dr.texture(boundary_mode='cube') does, with seamless filtering across
  face edges (a tap beyond a cube corner averages the three corner texels);
* `resize_bilinear` - F.interpolate(mode='bilinear', align_corners=False).
"""

from __future__ import annotations

import numpy as np
import torch


def grid_sample_bilinear(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Sample img (H, W, C) at grid (..., 2) of [-1, 1] (x, y) coordinates,
    align_corners=False with border padding."""
    h, w, _ = img.shape
    gx = (grid[..., 0] + 1.0) * (w / 2.0) - 0.5
    gy = (grid[..., 1] + 1.0) * (h / 2.0) - 0.5
    return _bilinear_gather(img, gx, gy)


def _bilinear_gather(img: torch.Tensor, gx: torch.Tensor, gy: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch at fractional pixel coordinates, clamped to the edge."""
    h, w, _ = img.shape
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    x0l, y0l = x0.long(), y0.long()
    x0i, x1i = x0l.clamp(0, w - 1), (x0l + 1).clamp(0, w - 1)
    y0i, y1i = y0l.clamp(0, h - 1), (y0l + 1).clamp(0, h - 1)
    top = img[y0i, x0i] * (1 - fx) + img[y0i, x1i] * fx
    bot = img[y1i, x0i] * (1 - fx) + img[y1i, x1i] * fx
    return top * (1 - fy) + bot * fy


def _cube_face_dir(f: int, u: float, v: float):
    """Un-normalized direction of face f at in-face (u, v) in [-1, 1]^2, the
    inverse of the (u, v) extraction in sample_cubemap."""
    return {
        0: (1.0, -v, -u),
        1: (-1.0, -v, u),
        2: (u, 1.0, v),
        3: (u, -1.0, -v),
        4: (u, -v, 1.0),
        5: (-u, -v, -1.0),
    }[f]


def _build_cube_adjacency():
    """The 24-entry face-edge table: (face, edge) -> (neighbour face,
    neighbour edge, flip).  Edges 0..3 are u=-1, u=+1, v=-1, v=+1, each
    parametrized by the other in-face coordinate.  Two faces share an edge
    when their corner directions coincide (their components are exactly
    +-1, so the comparison is exact); flip records whether the along-edge
    parametrizations run opposite ways."""

    def corners(f, e):
        pts = {
            0: ((-1.0, -1.0), (-1.0, 1.0)),  # u=-1, t = v
            1: ((1.0, -1.0), (1.0, 1.0)),    # u=+1, t = v
            2: ((-1.0, -1.0), (1.0, -1.0)),  # v=-1, t = u
            3: ((-1.0, 1.0), (1.0, 1.0)),    # v=+1, t = u
        }[e]
        return tuple(_cube_face_dir(f, u, v) for u, v in pts)

    nface = np.zeros((6, 4), np.int64)
    nedge = np.zeros((6, 4), np.int64)
    nflip = np.zeros((6, 4), np.int64)
    for f in range(6):
        for e in range(4):
            c = corners(f, e)
            found = False
            for g in range(6):
                if g == f:
                    continue
                for e2 in range(4):
                    c2 = corners(g, e2)
                    if c2 == c or c2 == (c[1], c[0]):
                        nface[f, e], nedge[f, e] = g, e2
                        nflip[f, e] = int(c2 == (c[1], c[0]))
                        found = True
            if not found:
                raise RuntimeError(f"cube face {f} edge {e} has no neighbour")
    return nface, nedge, nflip


_NEIGH_FACE, _NEIGH_EDGE, _NEIGH_FLIP = _build_cube_adjacency()


def sample_cubemap(cubemap: torch.Tensor, dirs: torch.Tensor, seam: bool = True) -> torch.Tensor:
    """Fetch a cubemap (6, R, R, C) along directions dirs (..., 3).

    Faces: 0 +X (u=-z/|x|, v=-y/|x|), 1 -X (u=z, v=-y), 2 +Y (u=x, v=z),
    3 -Y (u=x, v=-z), 4 +Z (u=x, v=-y), 5 -Z (u=-x, v=-y).  seam=True
    filters across face edges (the bilinear tap outside a face reads the
    adjacent face's texel; beyond a corner, the mean of the three corner
    texels); seam=False clamps to the face's edge."""
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()

    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    ma = torch.where(is_x, ax, torch.where(is_y, ay, az)).clamp_min(1e-12)

    u = torch.where(is_x, torch.where(x > 0, -z / ma, z / ma),
                    torch.where(is_y, x / ma, torch.where(z > 0, x / ma, -x / ma)))
    v = torch.where(is_x, -y / ma, torch.where(is_y, torch.where(y > 0, z / ma, -z / ma), -y / ma))

    r = cubemap.shape[1]
    # Texel centres at (-1 + 1/r) .. (1 - 1/r)  <->  pixels 0 .. r-1.
    gx = (u + 1.0) * (r / 2.0) - 0.5
    gy = (v + 1.0) * (r / 2.0) - 0.5
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()

    if seam:
        def fetch(xi, yi):
            return _fetch_seam(cubemap, face, xi, yi)
    else:
        def fetch(xi, yi):
            return cubemap[face, yi.clamp(0, r - 1), xi.clamp(0, r - 1)]

    top = fetch(x0i, y0i) * (1 - fx) + fetch(x0i + 1, y0i) * fx
    bot = fetch(x0i, y0i + 1) * (1 - fx) + fetch(x0i + 1, y0i + 1) * fx
    return top * (1 - fy) + bot * fy


def _fetch_seam(cubemap: torch.Tensor, face: torch.Tensor, xi: torch.Tensor,
                yi: torch.Tensor) -> torch.Tensor:
    """One nearest-texel gather with cross-face edge wrapping.  xi, yi are
    integer taps in [-1, R]: in-range taps read their own face; an
    out-of-range coordinate reads the adjacent face's border texel at the
    same along-edge position; taps beyond a corner (both out) average the
    three texels that meet at that cube corner."""
    r = cubemap.shape[1]
    dev = cubemap.device
    nface = torch.from_numpy(_NEIGH_FACE).to(dev)
    nedge = torch.from_numpy(_NEIGH_EDGE).to(dev)
    nflip = torch.from_numpy(_NEIGH_FLIP).to(dev)

    x_out = (xi < 0) | (xi > r - 1)
    y_out = (yi < 0) | (yi > r - 1)
    xc = xi.clamp(0, r - 1)
    yc = yi.clamp(0, r - 1)

    def neighbor(edge, j):
        """Texel (face', y', x') adjacent across `edge` at along-edge j."""
        g = nface[face, edge]
        e2 = nedge[face, edge]
        j2 = torch.where(nflip[face, edge] == 1, r - 1 - j, j)
        # The border line of edge e2 on face g: u=-1 -> x=0, u=+1 -> x=r-1,
        # v=-1 -> y=0, v=+1 -> y=r-1; the along-edge coordinate is the other.
        nx = torch.where(e2 == 0, 0, torch.where(e2 == 1, r - 1, j2))
        ny = torch.where(e2 == 2, 0, torch.where(e2 == 3, r - 1, j2))
        return g, ny, nx

    x_edge = torch.where(xi < 0, 0, 1)
    y_edge = torch.where(yi < 0, 2, 3)
    gx_f, gx_y, gx_x = neighbor(x_edge, yc)  # across the u edge
    gy_f, gy_y, gy_x = neighbor(y_edge, xc)  # across the v edge

    own = cubemap[face, yc, xc]
    via_x = cubemap[gx_f, gx_y, gx_x]
    via_y = cubemap[gy_f, gy_y, gy_x]

    corner = (x_out & y_out)[..., None]
    x_only = (x_out & ~y_out)[..., None]
    y_only = (y_out & ~x_out)[..., None]
    out = torch.where(x_only, via_x, torch.where(y_only, via_y, own))
    return torch.where(corner, (own + via_x + via_y) / 3.0, out)


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(H, W, C) -> (out_h, out_w, C), half-pixel-centre bilinear."""
    h, w, _ = img.shape
    ys = (torch.arange(out_h, dtype=torch.float32, device=img.device) + 0.5) * (h / out_h) - 0.5
    xs = (torch.arange(out_w, dtype=torch.float32, device=img.device) + 0.5) * (w / out_w) - 0.5
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    return _bilinear_gather(img, gx, gy)
