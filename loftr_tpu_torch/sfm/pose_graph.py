"""Pose-graph construction from pairwise matches; a numpy copy of
``loftr_tpu.sfm.pose_graph`` (host code there too).

Keyframes are nodes; edges carry RANSAC-estimated relative poses.  For
RGB-D-style sequences (ScanNet), per-edge translation scale is resolved
metrically by comparing triangulated match depths against the measured depth
map; world poses are initialized by chaining edges, and feature tracks are
built by union-find over (keyframe, coarse-cell) observations.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np


class Edge(NamedTuple):
    i: int                  # keyframe indices
    j: int
    R: np.ndarray           # [3, 3] relative rotation (i -> j frame)
    t: np.ndarray           # [3] relative translation (metric if scaled)
    kpts_i: np.ndarray      # [M, 2] pixel coords in frame i
    kpts_j: np.ndarray      # [M, 2]
    cells_i: np.ndarray     # [M] coarse-cell ids (track keys)
    cells_j: np.ndarray     # [M]


def triangulate_pair(R: np.ndarray, t: np.ndarray, p0: np.ndarray,
                     p1: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Two-view triangulation in frame i's coordinates.

    R, t: relative pose (x_j = R x_i + t); p0/p1: [M, 2] NORMALIZED coords.
    Returns (X [M, 3] in frame i, depth_i [M]).
    """
    x0 = np.concatenate([p0, np.ones_like(p0[:, :1])], -1)
    x1 = np.concatenate([p1, np.ones_like(p1[:, :1])], -1)
    Rx0 = x0 @ R.T
    a11 = np.sum(Rx0 * Rx0, -1)
    a12 = -np.sum(Rx0 * x1, -1)
    a22 = np.sum(x1 * x1, -1)
    b1 = -np.sum(Rx0 * t, -1)
    b2 = np.sum(x1 * t, -1)
    det = a11 * a22 - a12 * a12
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    z0 = (b1 * a22 - b2 * a12) / det
    return x0 * z0[:, None], z0


def metric_scale_from_depth(z_triangulated: np.ndarray,
                            z_measured: np.ndarray,
                            min_depth: float = 0.1) -> Optional[float]:
    """Median ratio measured/triangulated over valid matches (RGB-D scale
    resolution for the unit-norm essential-matrix translation)."""
    ok = (z_triangulated > 1e-6) & (z_measured > min_depth)
    if ok.sum() < 5:
        return None
    return float(np.median(z_measured[ok] / z_triangulated[ok]))


def chain_world_poses(n_frames: int, edges: List[Edge]
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Initialize world->cam poses by chaining sequential edges
    (frame 0 = identity).  Uses the first edge found for each (k, k+1)."""
    R_w = np.tile(np.eye(3), (n_frames, 1, 1))
    t_w = np.zeros((n_frames, 3))
    seq = {}
    for e in edges:
        if e.j == e.i + 1 and e.i not in seq:
            seq[e.i] = e
    for k in range(n_frames - 1):
        e = seq.get(k)
        if e is None:
            R_w[k + 1] = R_w[k]
            t_w[k + 1] = t_w[k]
            continue
        # x_{k+1} = R_e x_k + t_e ; world->k is (R_w[k], t_w[k])
        R_w[k + 1] = e.R @ R_w[k]
        t_w[k + 1] = e.R @ t_w[k] + e.t
    return R_w, t_w


class _UnionFind:
    def __init__(self):
        self.parent: Dict = {}

    def find(self, x):
        self.parent.setdefault(x, x)
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root

    def union(self, a, b):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[rb] = ra


def build_tracks(edges: List[Edge], max_obs_per_track: int = 8
                 ) -> List[List[Tuple[int, np.ndarray]]]:
    """Union-find feature tracks keyed by (keyframe, coarse-cell).

    Returns a list of tracks; each track is [(frame, kpt_px [2]), ...],
    de-duplicated per frame, length >= 2.
    """
    uf = _UnionFind()
    obs: Dict[tuple, np.ndarray] = {}
    for e in edges:
        for m in range(len(e.cells_i)):
            a = (e.i, int(e.cells_i[m]))
            b = (e.j, int(e.cells_j[m]))
            obs.setdefault(a, e.kpts_i[m])
            obs.setdefault(b, e.kpts_j[m])
            uf.union(a, b)
    groups: Dict = {}
    for key in obs:
        groups.setdefault(uf.find(key), []).append(key)
    tracks = []
    for members in groups.values():
        seen_frames = {}
        for frame, cell in sorted(members):
            if frame not in seen_frames:
                seen_frames[frame] = obs[(frame, cell)]
        if len(seen_frames) >= 2:
            track = sorted(seen_frames.items())[:max_obs_per_track]
            tracks.append([(f, kp) for f, kp in track])
    return tracks
