"""Linear Morton-order octree (counterpart of ``triplet_match_tpu.ops.octree``).

Dense-array equivalent of the reference's pointer-based octree
(include/octree, octree.ipp, impl/octree.hpp), which the reference builds but
never uses in the live match path (only a typedef at scene:21).  Points get
Morton codes (batched, on the cloud's device), the hierarchy is cut at a
subdivision criterion on the host, and nodes live in flat numpy arrays equal to
the JAX package's.

Subdivision criteria mirror ``subdivision_criterion_t`` (octree:35-48):
  max_point_count  — subdivide while a cell holds more than N points
  min_voxel_size   — never create cells smaller than S
  max_voxel_size   — subdivide while cells are larger than S

Codes are uint32 values held in int64 (torch's uint32 lacks shifts on many
builds); every step stays below 2^32.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Literal

import numpy as np
import torch


def _part1by2(x: torch.Tensor) -> torch.Tensor:
    """Spread the bits of a 10-bit int into every 3rd bit (Morton helper)."""
    x = x.to(torch.int64) & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


def morton_codes(xyz: torch.Tensor, lower, upper, depth: int) -> torch.Tensor:
    """[N, 3] positions -> [N] Morton codes (int64 holding uint32) at ``depth`` (<= 10)."""
    cells = 1 << depth
    lower = torch.as_tensor(lower, dtype=torch.float32, device=xyz.device)
    upper = torch.as_tensor(upper, dtype=torch.float32, device=xyz.device)
    scale = upper - lower
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(((xyz - lower) / safe) * float(cells), 0.0, float(cells - 1))
    q = q.to(torch.int64)
    return _part1by2(q[..., 0]) | (_part1by2(q[..., 1]) << 1) | (_part1by2(q[..., 2]) << 2)


@dataclasses.dataclass(frozen=True)
class Octree:
    """Flat-array octree.

    Node arrays (length = node count):
      code:     Morton prefix of the node at its depth
      depth:    node depth (root = 0)
      parent:   parent node index (-1 for root)
      is_leaf:  leaf flag
      point_start/point_count: contiguous range into ``order`` (leaves);
        branches cover their descendants' union.
      bbox_lo/bbox_hi: [M, 3] node bounds
    order: [N] point indices sorted by Morton code (leaf ranges index this).
    """

    code: np.ndarray
    depth: np.ndarray
    parent: np.ndarray
    is_leaf: np.ndarray
    point_start: np.ndarray
    point_count: np.ndarray
    bbox_lo: np.ndarray
    bbox_hi: np.ndarray
    order: np.ndarray
    max_depth: int

    @property
    def node_count(self) -> int:
        return self.code.shape[0]

    # --- traversal views (octree.ipp:23-237) ---

    def depth_traversal(self) -> Iterator[int]:
        """Pre-order depth-first node indices."""
        children: dict[int, list[int]] = {}
        for i, p in enumerate(self.parent):
            if p >= 0:
                children.setdefault(int(p), []).append(i)
        stack = [0]
        while stack:
            n = stack.pop()
            yield n
            stack.extend(reversed(children.get(n, [])))

    def breadth_traversal(self) -> Iterator[int]:
        yield from (int(i) for i in np.argsort(self.depth, kind="stable"))

    def leaf_traversal(self) -> Iterator[int]:
        yield from (int(i) for i in np.where(self.is_leaf)[0])

    def branch_traversal(self) -> Iterator[int]:
        yield from (int(i) for i in np.where(~self.is_leaf)[0])

    def level_traversal(self, level: int) -> Iterator[int]:
        yield from (int(i) for i in np.where(self.depth == level)[0])

    def leaf_points(self, node: int) -> np.ndarray:
        s, c = int(self.point_start[node]), int(self.point_count[node])
        return self.order[s: s + c]


def from_pointcloud(
    cloud,
    max_depth: int = 8,
    criterion: Literal["max_point_count", "min_voxel_size", "max_voxel_size"] = "max_point_count",
    value: float = 32,
) -> Octree:
    """Build the octree (``octree<Point>::from_pointcloud``, octree:69-71).

    Morton codes are computed batched on the cloud's device; the (small)
    hierarchy cut is assembled on the host.
    """
    from triplet_match_tpu_torch.core.cloud import bbox as cloud_bbox

    lo_d, hi_d = cloud_bbox(cloud)
    lo = lo_d.cpu().numpy()
    hi = hi_d.cpu().numpy()
    span = float(np.max(hi - lo))
    # octants are anisotropic halves of the cloud bbox (morton_codes
    # normalizes per axis), so node extents at depth d are (hi-lo)/2^d; the
    # size criteria follow the reference's min/max coefficient of the node
    # bbox extent (impl/octree.hpp:99-100)
    min_ext = float(np.min(hi - lo))

    valid = cloud.valid.cpu().numpy()
    codes = morton_codes(cloud.xyz, lo_d, hi_d, max_depth).cpu().numpy().astype(np.uint32)
    codes = codes[valid]
    pts_idx = np.where(valid)[0]
    order_local = np.argsort(codes, kind="stable")
    codes_sorted = codes[order_local]
    order = pts_idx[order_local].astype(np.int32)
    n = codes_sorted.shape[0]

    def cell_size(depth):
        return span / (1 << depth) if depth > 0 else span

    def should_split(depth, count):
        if depth >= max_depth or count <= 1:
            return False
        if criterion == "max_point_count":
            return count > value
        if criterion == "min_voxel_size":
            # subdivide while the SMALLEST node extent still exceeds 2S, so
            # no child axis drops below S (impl/octree.hpp:100 minCoeff)
            return min_ext / (1 << depth) > 2.0 * value
        if criterion == "max_voxel_size":
            return cell_size(depth) > value
        raise ValueError(criterion)

    nodes = []  # [code_prefix, depth, parent, start, count, is_leaf]

    def build(prefix, depth, parent, start, count):
        idx = len(nodes)
        nodes.append([prefix, depth, parent, start, count, True])
        if not should_split(depth, count):
            return
        nodes[idx][5] = False
        shift = 3 * (max_depth - depth - 1)
        sub = (codes_sorted[start: start + count] >> np.uint32(shift)) & 0x7
        for octant in range(8):
            mask = sub == octant
            c = int(mask.sum())
            if c == 0:
                continue
            build((prefix << 3) | octant, depth + 1, idx, start + int(np.argmax(mask)), c)

    build(0, 0, -1, 0, n)

    m = len(nodes)
    code = np.array([x[0] for x in nodes], np.uint32)
    depth = np.array([x[1] for x in nodes], np.int32)
    parent = np.array([x[2] for x in nodes], np.int32)
    start = np.array([x[3] for x in nodes], np.int32)
    count = np.array([x[4] for x in nodes], np.int32)
    is_leaf = np.array([x[5] for x in nodes], bool)

    # node bounds from Morton prefixes
    bbox_lo = np.empty((m, 3), np.float32)
    bbox_hi = np.empty((m, 3), np.float32)
    ext = np.maximum(hi - lo, 1e-12)
    for i in range(m):
        d = int(depth[i])
        cx = cy = cz = 0
        c = int(code[i])
        for b in range(d):
            oct_ = (c >> (3 * (d - b - 1))) & 0x7
            cx = (cx << 1) | (oct_ & 1)
            cy = (cy << 1) | ((oct_ >> 1) & 1)
            cz = (cz << 1) | ((oct_ >> 2) & 1)
        cell = ext / (1 << d)
        bbox_lo[i] = lo + np.array([cx, cy, cz]) * cell
        bbox_hi[i] = bbox_lo[i] + cell

    return Octree(code, depth, parent, is_leaf, start, count, bbox_lo, bbox_hi, order, max_depth)
