"""The front end's check (perfbench/pipelines/front_end.py), which decides
``correct``: what the timed path produced, held against the plain
reference (perfbench/reference/), stage by stage; and ``judge``, which
every pipeline's numbers pass through.

From the window's last pass it takes, drawn from the seed, whole detector
batches of views and one whole chunk of pairs as the chunk loop ran them:

- detector: the reference detects the same views from the JPEG files (its
  own decoding and gray conversion) with the same checkpoint; the
  program's keypoints are held to the reference's by the Hausdorff
  distance between the valid sets of each view (``kp_gap_px``), and
  descriptors at coincident keypoints by their largest L2 gap
  (``desc_gap``);
- matcher: the reference matches the chunk's pairs from the program's own
  keypoints and descriptors (the program's state; the detector is held on
  its own above); ``match_gap`` is the widest gap by which a program
  match's reference score lies below the reference's best in its row or
  column, ``match_diff`` the program's and the reference's match sets'
  symmetric difference over the reference's count;
- verifier: the reference verifies the program's matches of the chunk
  (the same pairs, global ids and seed); ``pose_gap_deg`` is the largest
  rotation or translation-direction angle between the two poses of a pair
  both call valid, and 180 for a pair that one calls valid and the other
  not;
- the pass: ``rows_missing`` counts result rows missing for retrieved
  pairs and sequential pairs the retriever left out (exact: limit 0).

A number passes when it is at most its limit (perfbench/workloads/<cell>
.json). ``control`` holds the reference, computed one precision below the
configuration's, to the same rules in the program's place.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from perfbench.reference import detectors, matchers, verifier

ORDER = ("kp_gap_px", "desc_gap", "match_gap", "match_diff", "pose_gap_deg", "rows_missing")
FAR = 1e9  # the gap of a view where one side has keypoints and the other none


def read_gray(scene_dir: str, indices) -> np.ndarray:
    """The views as (B, H, W) float32 gray in [0, 1] (ITU-R BT.601 luma of
    the 8-bit RGB files, as an image loader reads them)."""
    from PIL import Image

    names = sorted(os.listdir(os.path.join(scene_dir, "images")))
    out = []
    for i in indices:
        with Image.open(os.path.join(scene_dir, "images", names[i])) as im:
            a = np.asarray(im.convert("RGB")).astype(np.float32)
        if a.max() > 1.5:
            a = a / 255.0
        out.append(a[..., 0] * 0.299 + a[..., 1] * 0.587 + a[..., 2] * 0.114)
    return np.stack(out)


def sample(seed: int, n_images: int, image_batch: int, n_batches: int) -> list:
    """Whole detector batches of views, drawn from the seed."""
    rng = np.random.default_rng(seed)
    total = -(-n_images // image_batch)
    picks = sorted(rng.choice(total, size=min(n_batches, total), replace=False).tolist())
    return [list(range(b * image_batch, min((b + 1) * image_batch, n_images))) for b in picks]


def check_chunk(seed: int, n_pairs: int, pair_batch: int) -> int:
    """The full chunk of pairs held, drawn from the seed (the pair count
    of a pass can differ from the warm-up's by a few similarity pairs)."""
    return int(np.random.default_rng([seed, 1]).integers(max(1, n_pairs // pair_batch)))


class Reference:
    """The plain reference of one configuration over one scene."""

    def __init__(self, config: dict, weights: dict, scene: dict, scene_dir: str, device):
        self.config, self.scene, self.scene_dir, self.device = config, scene, scene_dir, torch.device(device)
        det = config["settings"]["detector"]
        self.kind = det["name"]
        self.det_opts = {**config["detector_defaults"], **{k: v for k, v in det.items() if k != "name"}}
        self.net = detectors.load_superpoint(weights["detector"], self.device) if self.kind == "superpoint" else None
        self.matcher = config["settings"].get("matcher", {}).get("name", "mutual_nn")
        self.glue = matchers.load_lightglue(weights["matcher"], self.device) if self.matcher == "lightglue" else None
        self.two_view = {**config["two_view_defaults"], **config["settings"]["scene_optimizer"]["two_view"]}

    def detect(self, batch, low: bool = False):
        images = torch.as_tensor(read_gray(self.scene_dir, batch), device=self.device)
        sizes = [tuple(images.shape[-2:])] * len(batch)
        return detectors.detect(self.kind, images, sizes, self.det_opts, self.net, tf32=low)

    def match(self, d1, d2, k1, k2, m1, m2, low: bool = False):
        """-> (match_idx, match_mask, score, the judge's scores (P, K1, K2))."""
        if self.matcher == "lightglue":
            model = self.config["model"]
            wh = (self.scene["width"], self.scene["height"])
            return matchers.lightglue(self.glue, d1, d2, k1, k2, m1, m2, wh, model["lightglue_heads"],
                                      model["match_threshold"], low=low)
        return matchers.mutual_nn(d1, d2, m1, m2, verifier.MATCHING_RATIO, low=low)

    def calibration(self) -> tuple:
        """(focal (N,), principal point (N, 2)) of each view, read from the
        folder's data.mat: P = K [R | t] split by an RQ decomposition with a
        positive diagonal, K scaled to K[2, 2] = 1, the focal the mean of
        K's two, in float32 (as an Olsson loader reads the file)."""
        import scipy.io
        import scipy.linalg

        P = scipy.io.loadmat(os.path.join(self.scene_dir, "data.mat"))["P"]
        f, c = [], []
        for i in range(P.shape[1]):
            K, R = scipy.linalg.rq(np.asarray(P[0, i], np.float64)[:, :3])
            S = np.diag(np.sign(np.diag(K)))
            K, R = K @ S, S @ R
            if np.linalg.det(R) < 0:
                K = -K
            K = K / K[2, 2]
            f.append(np.float32(0.5 * (K[0, 0] + K[1, 1])))
            c.append(np.asarray([K[0, 2], K[1, 2]], np.float32))
        return torch.as_tensor(np.asarray(f), device=self.device), torch.as_tensor(np.stack(c), device=self.device)

    def verify(self, i1, i2, k1, k2, midx, mmask, mscore, pair_ids, seed, low: bool = False):
        f, c = self.calibration()
        return verifier.verify(k1, k2, midx.to(torch.int64), mmask, mscore, f[i1], f[i2], c[i1], c[i2], pair_ids,
                               seed, self.two_view, tf32=low)


def _hausdorff(a, b) -> float:
    if len(a) == 0 and len(b) == 0:
        return 0.0
    if len(a) == 0 or len(b) == 0:
        return FAR
    d = torch.cdist(a.double(), b.double())
    return float(max(d.min(1).values.max(), d.min(0).values.max()))


def _desc_gap(ka, da, kb, db) -> float:
    """Largest descriptor gap of a keypoint of ``a`` to the closest
    descriptor among ``b``'s keypoints at its position."""
    if len(ka) == 0 or len(kb) == 0:
        return 0.0
    same = torch.cdist(ka.double(), kb.double()) <= 1e-3
    dd = torch.cdist(da.double(), db.double())
    dd = torch.where(same, dd, torch.full_like(dd, float("inf"))).min(1).values
    dd = dd[torch.isfinite(dd)]
    return float(dd.max()) if len(dd) else 0.0


def judge(numbers: dict, limits: dict, order=ORDER) -> bool:
    """Each number of ``order`` that was read is at most its limit."""
    return all(numbers[k] <= limits[k] for k in order if k in numbers)


def compare(ref: Reference, out, batches: list, chunk_pairs: np.ndarray, start: int, matches: dict,
            control: bool = False, block: int = 16) -> dict:
    """The check's numbers for a pass's outputs ``out`` (an
    adapter.PassOutput, or with ``control`` the reference one precision
    below in the program's place)."""
    dev = ref.device
    nums = {"kp_gap_px": 0.0, "desc_gap": 0.0}
    for batch in batches:
        rk, rm, rd = ref.detect(batch)
        if control:
            pk, pm, pd = ref.detect(batch, low=True)
        else:
            pk, pm, pd = (torch.as_tensor(a[batch], device=dev) for a in (out.kp_xy, out.kp_mask, out.descs))
        for j in range(len(batch)):
            a, b = pk[j][pm[j]], rk[j][rm[j]]
            nums["kp_gap_px"] = max(nums["kp_gap_px"], _hausdorff(a, b))
            nums["desc_gap"] = max(nums["desc_gap"], _desc_gap(a, pd[j][pm[j]], b, rd[j][rm[j]]),
                                   _desc_gap(b, rd[j][rm[j]], a, pd[j][pm[j]]))

    i1 = torch.as_tensor(chunk_pairs[:, 0], device=dev)
    i2 = torch.as_tensor(chunk_pairs[:, 1], device=dev)
    kp = torch.as_tensor(out.kp_xy, device=dev)
    km = torch.as_tensor(out.kp_mask, device=dev)
    ds = torch.as_tensor(out.descs, device=dev)
    gap, n_ref, n_diff, low_out = 0.0, 0, 0, []
    for s in range(0, len(chunk_pairs), block):
        b = slice(s, s + block)
        args = (ds[i1[b]], ds[i2[b]], kp[i1[b]], kp[i2[b]], km[i1[b]], km[i2[b]])
        r_idx, r_ok, _r_score, scores = ref.match(*args)
        if control:
            p_idx, p_ok, p_score, _ = ref.match(*args, low=True)
            low_out.append((p_idx, p_ok, p_score))
        else:
            p_idx = torch.as_tensor(matches["match_idx"][b], device=dev)
            p_ok = torch.as_tensor(matches["match_mask"][b], device=dev)
        rows = torch.where(p_ok, p_idx.to(torch.int64), 0)
        chosen = torch.gather(scores, 2, rows[..., None])[..., 0]
        row_best = scores.amax(2)
        col_best = torch.gather(scores.amax(1), 1, rows)
        g = torch.where(p_ok, torch.maximum(row_best - chosen, col_best - chosen), torch.zeros_like(chosen))
        gap = max(gap, float(g.max()) if g.numel() else 0.0)
        same = p_ok & r_ok & (p_idx == r_idx)
        n_ref += int(r_ok.sum())
        n_diff += int(p_ok.sum() + r_ok.sum() - 2 * same.sum())
        del scores
    nums["match_gap"] = gap
    nums["match_diff"] = n_diff / max(n_ref, 1)

    if control:
        midx, mok, mscore = (torch.cat(x) for x in zip(*low_out))
    else:
        midx, mok, mscore = (torch.as_tensor(matches[k], device=dev) for k in ("match_idx", "match_mask",
                                                                                "match_score"))
    pair_ids = torch.arange(start, start + len(chunk_pairs), device=dev)
    r = ref.verify(i1, i2, kp[i1], kp[i2], midx, mok, mscore, pair_ids, out.seed)
    if control:
        c = ref.verify(i1, i2, kp[i1], kp[i2], midx, mok, mscore, pair_ids, out.seed, low=True)
        p = {"R": c["R"], "t": c["t"], "valid": c["valid"]}
    else:
        rows = slice(start, start + len(chunk_pairs))
        p = {"R": torch.as_tensor(out.result["i2Ri1"][rows], device=dev),
             "t": torch.as_tensor(out.result["i2Ui1"][rows], device=dev),
             "valid": torch.as_tensor(out.result["valid"][rows], device=dev)}
    # chord forms in float64: the trace form rounds identical poses to ~0.03 degrees
    dR = torch.linalg.matrix_norm(p["R"].double() - r["R"].double())
    rot = torch.rad2deg(2.0 * torch.arcsin(torch.clamp(dR / (2.0 * math.sqrt(2.0)), max=1.0)))
    dt = torch.linalg.vector_norm(p["t"].double() - r["t"].double(), dim=-1)
    tr = torch.rad2deg(2.0 * torch.arcsin(torch.clamp(dt / 2.0, max=1.0)))
    gap = torch.where(p["valid"] & r["valid"], torch.maximum(rot, tr), torch.zeros_like(rot))
    gap = torch.where(p["valid"] != r["valid"], torch.full_like(gap, 180.0), gap)
    nums["pose_gap_deg"] = float(gap.max()) if gap.numel() else 0.0
    for k, v in nums.items():
        if not math.isfinite(v):
            nums[k] = FAR
    return nums


def rows_missing(out, lookahead: int) -> int:
    """Result rows missing for the retrieved pairs, plus the sequential
    pairs (0 < j - i <= lookahead) the retriever left out."""
    n = int(out.kp_xy.shape[0])
    have = {tuple(p) for p in out.pairs.tolist()}
    seq = sum(1 for i in range(n) for j in range(i + 1, min(i + lookahead, n - 1) + 1) if (i, j) not in have)
    return len(out.pairs) - len(out.result["valid"]) + seq
