"""Piecewise-linear Cartesian reference paths (port of ``boundmpc_tpu/path.py``).

The whole path is built once on the host (numpy + scipy) into stacked arrays
of static shape; the sliding window is a gather (``window``) and the sector
advance a branch-free count (``advance_sector``), both usable under
`torch.func.vmap` with per-lane sectors.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch


class PathData(NamedTuple):
    """Stacked per-segment path arrays (capacity S, leading batch dims ok)."""

    seg_p0: torch.Tensor  # (S, 3) segment start position
    seg_iw: torch.Tensor  # (S, 3) integrated omega at segment start
    seg_dp: torch.Tensor  # (S, 3) unit position direction
    seg_dr: torch.Tensor  # (S, 3) rotation velocity per unit phi
    seg_dr_unit: torch.Tensor  # (S, 3) normalized seg_dr (or [0,1,0] fallback)
    seg_len: torch.Tensor  # (S,)
    phi_start: torch.Tensor  # (S + 1,) cumulative switching values
    bp1: torch.Tensor  # (S, 3)
    bp2: torch.Tensor  # (S, 3)
    br1: torch.Tensor  # (S, 3)
    br2: torch.Tensor  # (S, 3)
    asymm_lower: torch.Tensor  # (S, 4)
    asymm_upper: torch.Tensor  # (S, 4)
    via_rotvec: torch.Tensor  # (S + 1, 3) rotation vector at each via point
    phi_max: torch.Tensor  # () total arc length (+ bias)
    n_real: torch.Tensor  # () int32: number of real segments
    s: torch.Tensor  # () bound slope parameter
    e_p_min: torch.Tensor  # ()
    e_r_min: torch.Tensor  # ()
    e_p_max: torch.Tensor  # ()
    e_r_max: torch.Tensor  # ()


class Window(NamedTuple):
    """Active ``nr_segs``-segment window, row-major (nr_segs, ...)."""

    p_ref: torch.Tensor  # (nr_segs, 6)  [pos ; iw]
    dp_ref: torch.Tensor  # (nr_segs, 6)  [unit dir ; dr]
    dp_normed: torch.Tensor  # (nr_segs, 3)
    phi_switch: torch.Tensor  # (nr_segs + 1,)
    bp1: torch.Tensor  # (nr_segs, 3)
    bp2: torch.Tensor
    br1: torch.Tensor
    br2: torch.Tensor
    asymm_lower: torch.Tensor  # (nr_segs, 4)
    asymm_upper: torch.Tensor  # (nr_segs, 4)
    seg_len: torch.Tensor  # (nr_segs,)


def _gram_schmidt(v_unit: np.ndarray, b: np.ndarray) -> np.ndarray:
    return b - (v_unit @ b) * v_unit


def build_path(
    p_via: Sequence[np.ndarray],
    r_via: Sequence[np.ndarray],
    p_lower: Sequence[np.ndarray],
    p_upper: Sequence[np.ndarray],
    r_lower: Sequence[np.ndarray],
    r_upper: Sequence[np.ndarray],
    bp1_in: Sequence[np.ndarray],
    br1_in: Sequence[np.ndarray],
    s: float,
    e_p_min: float,
    e_r_min: float,
    e_p_max: float,
    e_r_max: float,
    nr_segs: int,
    phi_bias: float = 0.0,
    capacity: int | None = None,
    dtype=np.float64,
) -> PathData:
    """Host-side path construction -> PathData of NUMPY arrays.

    ``r_via`` entries are 3x3 rotation matrices.  ``capacity`` pads the
    segment arrays to a static size so scenarios with different via counts
    batch together; it must be >= n_via - 1 + (nr_segs - 1).  Batching
    layers stack scenarios on the host and move each leaf to the device once.
    """
    from scipy.spatial.transform import Rotation as R

    p = [np.asarray(x, dtype=dtype) for x in p_via]
    r = [np.asarray(x, dtype=dtype) for x in r_via]
    n_via = len(p)
    n_real = n_via - 1
    S = n_real + (nr_segs - 1)
    if capacity is None:
        capacity = S
    if capacity < S:
        raise ValueError(f"capacity {capacity} too small for path of {S} segments")

    # Relative rotations and integrated omega at via points.
    dr_raw = [R.from_matrix(r[i + 1] @ r[i].T).as_rotvec() for i in range(n_real)]
    iw = [np.zeros(3, dtype=dtype)]
    for i in range(1, n_via):
        iw.append(iw[i - 1] + dr_raw[i - 1])

    # Position directions with degenerate-segment fallback.
    dp = []
    for i in range(n_real):
        d = p[i + 1] - p[i]
        if np.linalg.norm(d) < 1e-3:
            d = dp[-1].copy() if i > 0 else np.array([0.0, 1.0, 0.0], dtype=dtype)
        dp.append(d)

    # Arc lengths; pure-rotation segments get |dr| / pi, fully degenerate
    # segments a 1e-3 floor.
    seg_len = []
    for i in range(n_real):
        li = np.linalg.norm(p[i + 1] - p[i])
        if li < 1e-3:
            li = max(np.linalg.norm(dr_raw[i]) / np.pi, 1e-3)
        seg_len.append(li)
    phi_max = float(np.sum(seg_len)) + phi_bias

    dr = [dr_raw[i] / seg_len[i] for i in range(n_real)]

    # Pad with virtual segments (dr pad [1,1,1], repeat the rest).
    for _ in range(nr_segs - 1):
        p.append(p[-1])
        r.append(r[-1])
        iw.append(iw[-1])
        dp.append(dp[-1])
        dr.append(np.array([1.0, 1.0, 1.0], dtype=dtype))
        seg_len.append(1.0)

    # Error-plane bases per segment.
    bp1_l, bp2_l, br1_l, br2_l = [], [], [], []
    n_bases = min(len(bp1_in), S)
    for i in range(S):
        j = min(i, n_bases - 1)
        dpn = dp[i] / np.linalg.norm(dp[i])
        b1 = _gram_schmidt(dpn, np.asarray(bp1_in[j], dtype=dtype))
        nb = np.linalg.norm(b1)
        if nb < 1e-3:
            alt = np.array([1.0, 0.0, 0.0], dtype=dtype)
            if abs(dpn[0]) > 0.9:
                alt = np.array([0.0, 1.0, 0.0], dtype=dtype)
            b1 = _gram_schmidt(dpn, alt)
            nb = np.linalg.norm(b1)
        b1 = b1 / nb
        bp1_l.append(b1)
        bp2_l.append(np.cross(dpn, b1))

        ndr = np.linalg.norm(dr[i])
        omega = dr[i] / ndr if ndr > 1e-4 else np.array([0.0, 1.0, 0.0], dtype=dtype)
        c1 = _gram_schmidt(omega, np.asarray(br1_in[j], dtype=dtype))
        nc = np.linalg.norm(c1)
        if nc < 1e-3:
            alt = np.array([1.0, 0.0, 0.0], dtype=dtype)
            if abs(omega[0]) > 0.9:
                alt = np.array([0.0, 1.0, 0.0], dtype=dtype)
            c1 = _gram_schmidt(omega, alt)
            nc = np.linalg.norm(c1)
        c1 = c1 / nc
        br1_l.append(c1)
        br2_l.append(np.cross(omega, c1))

    # Per-segment asymmetric limit rectangles (lists indexed by start via).
    def _lim(lst, i):
        j = min(i, len(lst) - 1)
        return np.asarray(lst[j], dtype=dtype)

    asymm_lower = np.stack(
        [np.concatenate([_lim(p_lower, i), _lim(r_lower, i)]) for i in range(S)]
    )
    asymm_upper = np.stack(
        [np.concatenate([_lim(p_upper, i), _lim(r_upper, i)]) for i in range(S)]
    )

    phi_start = phi_bias + np.concatenate([[0.0], np.cumsum(seg_len)])

    via_rotvec = np.stack([R.from_matrix(m).as_rotvec() for m in r])  # (S+1, 3)

    def pad_to(a, rows):
        a = np.asarray(a, dtype=dtype)
        if a.shape[0] >= rows:
            return a[:rows]
        reps = np.repeat(a[-1:], rows - a.shape[0], axis=0)
        return np.concatenate([a, reps], axis=0)

    def pad_seg(a):
        return pad_to(a, capacity)

    seg_dr = np.stack(dr)
    dr_norm = np.linalg.norm(seg_dr, axis=-1, keepdims=True)
    seg_dr_unit = np.where(
        dr_norm > 1e-4, seg_dr / np.maximum(dr_norm, 1e-30), np.array([0.0, 1.0, 0.0])
    )
    dp_arr = np.stack(dp)
    dp_unit = dp_arr / np.linalg.norm(dp_arr, axis=-1, keepdims=True)

    # phi_start padding continues the cumsum with unit segments.
    extra = capacity - S
    phi_start_pad = np.concatenate(
        [phi_start, phi_start[-1] + np.arange(1, extra + 1, dtype=dtype)]
    )

    return PathData(
        seg_p0=pad_seg(np.stack(p[:S])),
        seg_iw=pad_seg(np.stack(iw[:S])),
        seg_dp=pad_seg(dp_unit),
        seg_dr=pad_seg(seg_dr),
        seg_dr_unit=pad_seg(seg_dr_unit),
        seg_len=pad_seg(np.asarray(seg_len)),
        phi_start=np.asarray(phi_start_pad, dtype=dtype),
        bp1=pad_seg(np.stack(bp1_l)),
        bp2=pad_seg(np.stack(bp2_l)),
        br1=pad_seg(np.stack(br1_l)),
        br2=pad_seg(np.stack(br2_l)),
        asymm_lower=pad_seg(asymm_lower),
        asymm_upper=pad_seg(asymm_upper),
        via_rotvec=pad_to(via_rotvec, capacity + 1),
        phi_max=np.asarray(phi_max, dtype=dtype),
        n_real=np.asarray(n_real, dtype=np.int32),
        s=np.asarray(s, dtype=dtype),
        e_p_min=np.asarray(e_p_min, dtype=dtype),
        e_r_min=np.asarray(e_r_min, dtype=dtype),
        e_p_max=np.asarray(e_p_max, dtype=dtype),
        e_r_max=np.asarray(e_r_max, dtype=dtype),
    )


def locate_sector(path: PathData, phi: torch.Tensor) -> torch.Tensor:
    """Sector containing ``phi``: the number of switching points strictly
    below it, clamped to the real segments (direction-free)."""
    interior = torch.arange(path.phi_start.shape[0] - 2, device=path.phi_start.device)
    return torch.sum(
        (phi > path.phi_start[1:-1]) & (interior < path.n_real - 1), dim=-1
    ).to(torch.int32)


def advance_sector(path: PathData, sector: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Forward-only sector advance: never below ``sector``."""
    return torch.maximum(sector, locate_sector(path, phi))


def window(path: PathData, sector: torch.Tensor, nr_segs: int) -> Window:
    """Gather the active window starting at ``sector`` (static size).

    Like ``lax.dynamic_slice_in_dim``, the start is clamped so that the slice
    stays in bounds: rows ``clamp(sector, 0, len - size) + arange(size)``."""

    def slice0(a, size):
        start = torch.clamp(sector, 0, a.shape[0] - size).long()
        return a[start + torch.arange(size, device=a.device)]

    p_ref = torch.cat([slice0(path.seg_p0, nr_segs), slice0(path.seg_iw, nr_segs)], dim=-1)
    dp_ref = torch.cat([slice0(path.seg_dp, nr_segs), slice0(path.seg_dr, nr_segs)], dim=-1)
    return Window(
        p_ref=p_ref,
        dp_ref=dp_ref,
        dp_normed=slice0(path.seg_dr_unit, nr_segs),
        phi_switch=slice0(path.phi_start, nr_segs + 1),
        bp1=slice0(path.bp1, nr_segs),
        bp2=slice0(path.bp2, nr_segs),
        br1=slice0(path.br1, nr_segs),
        br2=slice0(path.br2, nr_segs),
        asymm_lower=slice0(path.asymm_lower, nr_segs),
        asymm_upper=slice0(path.asymm_upper, nr_segs),
        seg_len=slice0(path.seg_len, nr_segs),
    )


def segment_index(phi: torch.Tensor, phi_switch: torch.Tensor, nr_segs: int) -> torch.Tensor:
    """Index of the active window segment for path parameter ``phi``:
    segment i is active when phi < phi_switch[i + 1], else the last row."""
    return torch.sum(phi >= phi_switch[1:nr_segs], dim=-1).to(torch.int32)
