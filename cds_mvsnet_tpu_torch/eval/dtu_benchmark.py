"""DTU point-cloud benchmark scorer — Python replacement for the MATLAB eval.

Behavioral reference: evaluations/dtu/*.m in TruongKhang/cds-mvsnet
(BaseEvalMain_web.m, PointCompareMain.m, MaxDistCP.m, reducePts_haa.m,
ComputeStat_web.m). Pipeline per scan:

  1. stochastically grid-reduce predicted points to >= 0.2 mm spacing
     (reducePts_haa: random order, drop every point within dst of a kept one)
  2. accuracy  = nearest-neighbor distance pred -> GT structured-light scan
     completeness = distance GT -> pred (both clipped at 60 mm during
     computation; scipy cKDTree replaces the chunked-block MATLAB search)
  3. accuracy keeps only predictions inside the observability mask
     (ObsMask{set}_10.mat voxel grid); completeness keeps only GT points
     above the ground plane (Plane{set}.mat)
  4. discard distances >= 20 mm; per-scan means; final Acc/Comp/Overall =
     mean over the 22 scans (lists/dtu/test.txt)

Needs the official "SampleSet/MVS Data" directory (Points/stl plys +
ObsMask .mats), read via scipy.io.

Own copy of ``cds_mvsnet_tpu/eval/dtu_benchmark.py``. It stays float64 on
the host with ``scipy.spatial.cKDTree``: nearest-neighbour distances in fp32
on the card would lose the small distances (a tenth of a millimetre between
coordinates of hundreds) to cancellation.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
from scipy.spatial import cKDTree

from ..io.ply import read_ply

__all__ = [
    "DTU_EVAL_SETS",
    "reduce_points",
    "nn_distances",
    "score_points",
    "evaluate_scan",
    "evaluate_scans",
]

DTU_EVAL_SETS = [1, 4, 9, 10, 11, 12, 13, 15, 23, 24, 29, 32, 33, 34, 48, 49, 62, 75, 77, 110, 114, 118]


def reduce_points(
    pts: np.ndarray, dst: float = 0.2, seed: int = 0, chunk: int = 500_000
) -> np.ndarray:
    """Stochastic min-distance reduction with reducePts_haa.m's exact
    semantics: visit points in random order; a point survives iff no
    earlier-visited SURVIVOR lies within Euclidean ``dst`` of it.

    Vectorized equivalent of the MATLAB greedy: process the visit order in
    chunks; each chunk first drops points within dst of an already-confirmed
    survivor (one KD query), then resolves the within-chunk greedy by a
    blocked-by-earlier-undecided fixed point over ``query_pairs`` (each round
    confirms points with no earlier undecided neighbor and kills points
    blocked by a newly-confirmed survivor; chain depth is short because disk
    graphs have bounded local rank chains).
    """
    pts = np.asarray(pts, np.float64)
    n = len(pts)
    if n == 0:
        return pts
    order = np.random.default_rng(seed).permutation(n)
    pts_o = pts[order]
    surv_chunks: list[np.ndarray] = []  # survivor coordinates, in rank order
    surv_orig: list[np.ndarray] = []  # original indices of survivors
    for a in range(0, n, chunk):
        cand = np.arange(a, min(a + chunk, n))
        if surv_chunks:
            tree = cKDTree(np.concatenate(surv_chunks))
            d, _ = tree.query(pts_o[cand], k=1, distance_upper_bound=dst)
            cand = cand[d > dst]  # query returns inf when nothing within dst
        if len(cand) == 0:
            continue
        sub = pts_o[cand]
        pairs = cKDTree(sub).query_pairs(dst, output_type="ndarray")
        alive = np.ones(len(cand), dtype=bool)
        if len(pairs):
            # pairs are (i < j) in visit-rank order: i blocks j
            undecided = np.ones(len(cand), dtype=bool)
            pi, pj = pairs[:, 0], pairs[:, 1]
            while undecided.any():
                blocked = np.zeros(len(cand), dtype=bool)
                blocked[pj[undecided[pi]]] = True
                # confirm points not blocked by any earlier undecided point
                newly = undecided & ~blocked
                if not newly.any():  # cycles impossible (i < j); safety only
                    break
                undecided &= ~newly
                # kill undecided points within dst of a newly-confirmed one
                dead = pj[newly[pi] & undecided[pj]]
                alive[dead] = False
                undecided[dead] = False
                # drop settled pairs: only undecided-target pairs with a
                # still-alive blocker can influence later rounds
                m = undecided[pj] & alive[pi]
                pi, pj = pi[m], pj[m]
        keep = cand[alive]
        surv_chunks.append(pts_o[keep])
        surv_orig.append(order[keep])
    kept = np.sort(np.concatenate(surv_orig))
    return pts[kept]


def nn_distances(q_from: np.ndarray, q_to: np.ndarray, max_dist: float = 60.0) -> np.ndarray:
    """Distance from each q_from point to its nearest q_to point, clipped to
    max_dist (MaxDistCP.m semantics; empty target => max_dist)."""
    if len(q_to) == 0:
        return np.full(len(q_from), max_dist, dtype=np.float64)
    tree = cKDTree(q_to)
    d, _ = tree.query(q_from, k=1, distance_upper_bound=max_dist)
    return np.minimum(np.nan_to_num(d, posinf=max_dist), max_dist)


def score_points(
    pred: np.ndarray,
    gt: np.ndarray,
    dst: float = 0.2,
    max_dist: float = 20.0,
    seed: int = 0,
) -> dict:
    """Mask-free accuracy/completeness between a predicted and a GT cloud.

    The ObsMask/Plane-free core of ``evaluate_scan`` (same reduce -> NN ->
    <max_dist filtering as BaseEvalMain_web.m / PointCompareMain.m), usable
    on synthetic scenes with exact geometry — the scorer-validation path when
    no official DTU SampleSet is available.
    """
    pred = reduce_points(np.asarray(pred, np.float64), dst, seed=seed)
    gt = np.asarray(gt, np.float64)
    d_acc = nn_distances(pred, gt)
    d_comp = nn_distances(gt, pred)
    fa = d_acc[d_acc < max_dist]
    fc = d_comp[d_comp < max_dist]
    return {
        "acc_mean": float(np.mean(fa)) if len(fa) else float("nan"),
        "acc_median": float(np.median(fa)) if len(fa) else float("nan"),
        "comp_mean": float(np.mean(fc)) if len(fc) else float("nan"),
        "comp_median": float(np.median(fc)) if len(fc) else float("nan"),
        "n_pred": int(len(pred)),
        "acc_inlier_frac": float(len(fa) / max(1, len(pred))),
        "comp_inlier_frac": float(len(fc) / max(1, len(gt))),
    }


@dataclass
class ScanResult:
    scan: int
    acc_mean: float
    comp_mean: float
    acc_median: float
    comp_median: float
    n_data: int
    n_stl: int


def evaluate_scan(
    pred_ply: str,
    gt_dir: str,
    scan: int,
    dst: float = 0.2,
    max_dist: float = 20.0,
    margin: int = 10,
) -> ScanResult:
    from scipy.io import loadmat

    pred, _ = read_ply(pred_ply)
    pred = reduce_points(pred.astype(np.float64), dst)

    stl, _ = read_ply(os.path.join(gt_dir, "Points", "stl", f"stl{scan:03d}_total.ply"))
    stl = stl.astype(np.float64)

    mask_mat = loadmat(os.path.join(gt_dir, "ObsMask", f"ObsMask{scan}_{margin}.mat"))
    obs_mask = mask_mat["ObsMask"]
    bb = mask_mat["BB"].astype(np.float64)  # (2, 3)
    res = float(np.asarray(mask_mat["Res"]).squeeze())

    d_data = nn_distances(pred, stl)  # pred -> GT  (accuracy)
    d_stl = nn_distances(stl, pred)  # GT -> pred  (completeness)

    # observability mask on predictions (PointCompareMain.m:37-46; MATLAB is
    # 1-based: Qv = round((q-BB(1,:))/Res + 1), valid when 1 <= Qv <= size)
    qv = np.round((pred - bb[0]) / res).astype(np.int64)  # 0-based equivalent
    inb = (
        (qv >= 0).all(axis=1)
        & (qv[:, 0] < obs_mask.shape[0])
        & (qv[:, 1] < obs_mask.shape[1])
        & (qv[:, 2] < obs_mask.shape[2])
    )
    in_mask = np.zeros(len(pred), dtype=bool)
    q = qv[inb]
    in_mask[inb] = obs_mask[q[:, 0], q[:, 1], q[:, 2]] > 0

    plane = loadmat(os.path.join(gt_dir, "ObsMask", f"Plane{scan}.mat"))["P"].reshape(4)
    above = stl @ plane[:3] + plane[3] > 0

    fd_data = d_data[in_mask]
    fd_data = fd_data[fd_data < max_dist]
    fd_stl = d_stl[above]
    fd_stl = fd_stl[fd_stl < max_dist]

    return ScanResult(
        scan=scan,
        acc_mean=float(np.mean(fd_data)) if len(fd_data) else float("nan"),
        comp_mean=float(np.mean(fd_stl)) if len(fd_stl) else float("nan"),
        acc_median=float(np.median(fd_data)) if len(fd_data) else float("nan"),
        comp_median=float(np.median(fd_stl)) if len(fd_stl) else float("nan"),
        n_data=len(fd_data),
        n_stl=len(fd_stl),
    )


def evaluate_scans(ply_dir: str, gt_dir: str, scans=None, name_fmt="mvsnet{scan:03d}_l3.ply"):
    """The full benchmark over ``scans``; returns (per-scan results, summary dict with
    the README.md:63-66 headline numbers: acc/comp/overall in mm)."""
    scans = scans or DTU_EVAL_SETS
    results = []
    for scan in scans:
        ply = os.path.join(ply_dir, name_fmt.format(scan=scan))
        if not os.path.exists(ply):
            alt = os.path.join(ply_dir, f"scan{scan}.ply")
            ply = alt if os.path.exists(alt) else ply
        results.append(evaluate_scan(ply, gt_dir, scan))
    acc = float(np.mean([r.acc_mean for r in results]))
    comp = float(np.mean([r.comp_mean for r in results]))
    return results, {"acc_mm": acc, "comp_mm": comp, "overall_mm": (acc + comp) / 2}
