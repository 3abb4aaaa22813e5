"""Hierarchical reconstruction: partition -> per-cluster MVO -> tree merge.

Port of gtsfm_tpu/scene/hierarchical.py. The front end (two-view over all
retrieved pairs, the future cut edges included) runs once as flat batches;
the METIS-class partition of the valid view graph routes edge subsets into
independent MultiViewOptimizer runs (the leaves, largest first), and the
bottom-up fold aligns sibling results with a Sim3 from cross-cluster 3D-3D
track pairs, fuses them and runs a parent BA (``merging/merge.py``). A
child whose merge fails is dropped (the larger child is kept), with the
reason recorded, as in the reference's ``drop_child_if_merging_fail``.

A leaf runs in a compact local camera space. Its cameras and edges are
padded as the reference pads them (to ``ceil_pow2(n, 8)`` and to the
largest leaf's counts), with in-range dummy edges (pair [0, 1], identity
rotation, invalid): the translation averaging's MFAS gate counts padded
edges (``E >= 3``), so without the padding a two-edge leaf would skip MFAS
here and not in the reference. The leaf's result returns to the global
camera space by index ops on the device: the real rows are selected first,
then written to their one global slot each.

With a ``cluster_cache`` (utils/cache.DiskCache) each leaf's result is
kept on disk, keyed on its edges, their relative poses and verified
correspondence masks, samples of its cameras' keypoints and the MVO
options, and a re-run with the same front-end output replays it: the
entry holds the leaf's scene as CPU tensors, its keypoint-to-track map
and its scalar metrics, and a hit moves the scene to the run's device.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.common.sfm_data import SceneMeta, SfmData
from gtsfm_tpu_torch.geometry import SE3
from gtsfm_tpu_torch.merging.merge import MergeOptions, merge_children
from gtsfm_tpu_torch.partitioner.partitioners import MetisPartitioner
from gtsfm_tpu_torch.products.types import ClusterTree
from gtsfm_tpu_torch.scene.mvo import MultiViewOptimizer, MVOOptions
from gtsfm_tpu_torch.utils.cache import content_key
from gtsfm_tpu_torch.utils.logger import get_logger
from gtsfm_tpu_torch.utils.numerics import ceil_pow2

logger = get_logger("hierarchical")

MAX_SIM3_PAIRS = 4096  # LMedS + IRLS saturates well below this many 3D-3D pairs


class HierarchicalOptions(NamedTuple):
    mvo: MVOOptions = MVOOptions()
    merge: MergeOptions = MergeOptions()
    max_depth: int = 3
    max_cluster_size: int = 40
    drop_child_if_merging_fail: bool = True


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _iter_nodes(tree: ClusterTree):
    yield tree
    for c in tree.children:
        yield from _iter_nodes(c)


def _kp_track_map(aux: dict, num_images: int, max_kp: int) -> np.ndarray:
    """Dense (num_images, max_kp) -> track index array from the MVO's aux
    arrays (-1 = no track): cross-cluster lookups are single gathers."""
    out = np.full((num_images, max_kp), -1, np.int32)
    if aux:
        out[np.asarray(aux["meas_cam"]), np.asarray(aux["meas_kp"])] = np.asarray(aux["meas_track"])
    return out


class HierarchicalReconstruction:
    """Runs the partitioned back end on flat front-end outputs."""

    def __init__(self, options: HierarchicalOptions = HierarchicalOptions(), cluster_cache=None):
        """cluster_cache: a DiskCache for the leaves' results, or None."""
        self.options = options
        self.cluster_cache = cluster_cache
        self.node_results = []  # [(path tuple, SfmData)] of the last run, postorder
        self._last_merge_fail = "unknown"

    def run(
        self,
        num_images: int,
        pairs: np.ndarray,
        tvr: dict,  # flat two-view outputs: numpy arrays or tensors
        keypoints_xy: np.ndarray,  # (N, K, 2)
        cal,  # calibrations [N] on the device the back end runs on
        meta: Optional[SceneMeta] = None,
    ) -> tuple:
        """-> (SfmData over the global camera space, metrics dict)."""
        opts = self.options
        dev = cal.u0.device  # a field of every calibration model
        host = {k: _host(tvr[k]) for k in ("valid", "num_inliers", "corr_i1", "corr_i2", "corr_mask")}
        rel_R = torch.as_tensor(tvr["i2Ri1"], dtype=torch.float32, device=dev)
        rel_U = torch.as_tensor(tvr["i2Ui1"], dtype=torch.float32, device=dev)
        keypoints_xy = np.asarray(keypoints_xy)
        valid = host["valid"].astype(bool)
        edges = np.asarray(pairs, np.int64).reshape(-1, 2)
        part = MetisPartitioner(max_depth=opts.max_depth, max_cluster_size=opts.max_cluster_size)
        tree = part.run(edges[valid], edge_weights=host["num_inliers"][valid])
        metrics = {"num_clusters": len(tree.leaves()), "tree_nodes": tree.num_nodes(), "partitioner": part.ran}

        eindex = {(int(a), int(b)): e for e, (a, b) in enumerate(edges)}

        def edge_subset(sub_edges: np.ndarray) -> np.ndarray:
            return np.array([eindex[(int(a), int(b))] for a, b in sub_edges], np.int64)

        mvo = MultiViewOptimizer(opts.mvo)
        cluster_metrics = []
        leaf_nodes = [nd for nd in _iter_nodes(tree) if nd.is_leaf and len(nd.value)]
        # every leaf pads to the largest leaf's bucket, as in the reference
        hwm_edges = max((ceil_pow2(len(nd.value), 8) for nd in leaf_nodes), default=0)
        hwm_cams = max((ceil_pow2(len(np.unique(nd.value)), 8) for nd in leaf_nodes), default=0)

        def run_leaf(node: ClusterTree):
            """MVO on the leaf's compact camera space, expanded back to the
            global one. -> (SfmData, (image, keypoint) -> track map) or None."""
            sel = edge_subset(node.value)
            sub_edges = edges[sel]
            local_cams = np.unique(sub_edges)
            cache_key = None
            if self.cluster_cache is not None:
                stride = max(1, keypoints_xy.shape[1] // 32)
                cache_key = content_key(sub_edges, rel_R[sel].cpu().numpy(), rel_U[sel].cpu().numpy(),
                                        host["corr_mask"][sel], keypoints_xy[local_cams][:, ::stride], repr(opts.mvo))
                hit = self.cluster_cache.get(cache_key)
                if hit is not None:
                    data_cpu, kp_map, m_cached = hit
                    cluster_metrics.append(dict(m_cached, cache_hit=True))
                    return data_cpu.map(lambda a: a.to(dev)), kp_map
            nl = len(local_cams)
            n_local = max(ceil_pow2(nl, 8), hwm_cams)
            g2l = np.full(num_images, -1, np.int64)
            g2l[local_cams] = np.arange(nl)
            E_raw = len(sel)
            padE = max(ceil_pow2(E_raw, 8), hwm_edges) - E_raw

            def _pad(a):
                return np.concatenate([a, np.zeros((padE,) + a.shape[1:], a.dtype)])

            pairs_l = _pad(g2l[sub_edges])
            pairs_l[E_raw:] = [0, 1]  # in-range dummy, pair_valid False
            sel_t = torch.as_tensor(sel, device=dev)
            R_l = torch.cat([rel_R[sel_t], torch.eye(3, device=dev).expand(padE, 3, 3)])
            U_l = torch.cat([rel_U[sel_t], torch.tensor([0.0, 0.0, 1.0], device=dev).expand(padE, 3)])
            # padded camera rows repeat a real camera; no edge touches them
            cam_pad_idx = np.concatenate([local_cams, np.full(n_local - nl, local_cams[0], np.int64)])
            cam_pad_t = torch.as_tensor(cam_pad_idx, device=dev)
            data_l, m = mvo.run(
                num_images=n_local, pairs=pairs_l, i2Ri1=R_l, i2Ui1=U_l,
                pair_valid=_pad(valid[sel]), num_inliers=_pad(host["num_inliers"][sel]),
                corr_i1=_pad(host["corr_i1"][sel]), corr_i2=_pad(host["corr_i2"][sel]),
                corr_mask=_pad(host["corr_mask"][sel]),
                keypoints_xy=keypoints_xy[cam_pad_idx], cal=cal.map(lambda a: a[cam_pad_t]), meta=None,
            )
            cluster_metrics.append({k: v for k, v in m.items() if k != "aux"})
            if m.get("failed"):
                return None
            # back to the global camera space: the leaf's real rows only,
            # each to its one global slot
            lc = torch.as_tensor(local_cams, device=dev)
            R_g = SE3.identity((num_images,), device=dev).R
            t_g = torch.zeros(num_images, 3, device=dev)
            R_g[lc] = data_l.poses.R[:nl]
            t_g[lc] = data_l.poses.t[:nl]
            pose_mask = torch.zeros(num_images, dtype=torch.bool, device=dev)
            pose_mask[lc] = data_l.pose_mask[:nl]
            cal_g = cal.with_params(cal.to_params().index_copy(0, lc, data_l.cal.to_params()[:nl]))
            data = SfmData(
                poses=SE3(R=R_g, t=t_g), pose_mask=pose_mask, cal=cal_g,
                points=data_l.points, track_mask=data_l.track_mask,
                meas_cam=cam_pad_t[data_l.meas_cam], meas_track=data_l.meas_track,
                meas_uv=data_l.meas_uv, meas_mask=data_l.meas_mask, meta=meta,
            )
            aux = m.get("aux", {})
            if aux:
                aux = dict(aux, meas_cam=local_cams[np.asarray(aux["meas_cam"])])
            kp_map = _kp_track_map(aux, num_images, keypoints_xy.shape[1])
            if cache_key is not None:
                self.cluster_cache.put(cache_key, (data.map(lambda a: a.cpu()), kp_map,
                                                   {k: v for k, v in m.items() if isinstance(v, (int, float, str))}))
            return data, kp_map

        def fold(node: ClusterTree, child_results):
            child_results = [c for c in child_results if c is not None]
            if node.is_leaf or not child_results:
                if len(node.value):
                    return leaf_results[id(node)] if id(node) in leaf_results else run_leaf(node)
                return child_results[0] if child_results else None
            if len(child_results) == 1:
                return child_results[0]
            # merge the children pairwise through this node's cut edges
            result = child_results[0]
            for other in child_results[1:]:
                merged = self._merge_pair(node, result, other, host, eindex, meta)
                if merged is None:
                    if not opts.drop_child_if_merging_fail:
                        return None
                    if other[0].number_tracks() > result[0].number_tracks():  # keep the larger child
                        result = other
                    metrics["merge_failures"] = metrics.get("merge_failures", 0) + 1
                    metrics.setdefault("merge_failure_reasons", []).append(self._last_merge_fail)
                else:
                    result = merged
            return result

        phase_sec = {"leaf": 0.0, "merge": 0.0}
        # leaf pre-pass, largest first (the reference's order, which sets its
        # shape high-water marks)
        leaf_results: dict = {}
        for nd in sorted(leaf_nodes, key=lambda x: -len(x.value)):
            t0 = time.perf_counter()
            leaf_results[id(nd)] = run_leaf(nd)
            dt = time.perf_counter() - t0
            phase_sec["leaf"] += dt
            logger.info("leaf (%d edges): %.1fs", len(nd.value), dt)

        self.node_results = []

        def walk(node: ClusterTree, path: tuple):
            """Postorder fold carrying the cluster path of each node."""
            child_results = [walk(c, path + (k + 1,)) for k, c in enumerate(node.children)]
            t0 = time.perf_counter()
            result = fold(node, child_results)
            if id(node) not in leaf_results:
                phase = "leaf" if node.is_leaf else "merge"
                dt = time.perf_counter() - t0
                phase_sec[phase] += dt
                logger.info("node %s (%s): %d edges in %.1fs%s", "/".join(map(str, path)) or "root", phase,
                            len(node.value), dt, "" if result is not None else " [FAILED]")
            if result is not None:
                self.node_results.append((path, result[0]))
            return result

        final = walk(tree, ())
        metrics["leaf_mvo_sec"] = phase_sec["leaf"]
        metrics["merge_sec"] = phase_sec["merge"]
        metrics["cluster_metrics"] = cluster_metrics
        if final is None:
            return SfmData.empty(num_images, meta=meta, device=dev), {**metrics, "failed": True}
        data, _ = final
        metrics["num_cameras_final"] = data.number_images()
        metrics["num_tracks_final"] = data.number_tracks()
        return data, metrics

    def _merge_pair(self, node, res_a, res_b, host, eindex, meta):
        """Merge two child results through the node's cut edges; None (and
        ``_last_merge_fail``) when they cannot be merged."""
        data_a, map_a = res_a
        data_b, map_b = res_b
        in_a = data_a.pose_mask.cpu().numpy()
        in_b = data_b.pose_mask.cpu().numpy()
        if (in_a & in_b).any():
            self._last_merge_fail = "overlapping_cameras"
            return None

        corr_i1, corr_i2, corr_mask = host["corr_i1"], host["corr_i2"], host["corr_mask"]
        ta_parts, tb_parts = [], []
        n_cut = n_orient = 0
        for a_img, b_img in node.value:
            i, j = int(a_img), int(b_img)
            e = eindex.get((i, j))
            if e is None:
                continue
            n_cut += 1
            msk = corr_mask[e]
            kp1 = corr_i1[e, msk].astype(np.int64)
            kp2 = corr_i2[e, msk].astype(np.int64)
            # orient: which child owns image i?
            if in_a[i] and in_b[j]:
                t_a, t_b = map_a[i, kp1], map_b[j, kp2]
            elif in_b[i] and in_a[j]:
                t_b, t_a = map_b[i, kp1], map_a[j, kp2]
            else:
                continue
            n_orient += 1
            ok = (t_a >= 0) & (t_b >= 0)
            ta_parts.append(t_a[ok])
            tb_parts.append(t_b[ok])
        ta = np.concatenate(ta_parts).astype(np.int64) if ta_parts else np.zeros(0, np.int64)
        tb = np.concatenate(tb_parts).astype(np.int64) if tb_parts else np.zeros(0, np.int64)
        if len(ta) > MAX_SIM3_PAIRS:
            # deterministic stride subsample keeps the edge coverage even
            keep = np.linspace(0, len(ta) - 1, MAX_SIM3_PAIRS).astype(np.int64)
            ta, tb = ta[keep], tb[keep]
        if len(ta) == 0:
            # cut edges not split across the children mean cameras dropped
            # below; map misses mean filtered tracks
            self._last_merge_fail = f"no_3d3d_pairs(cut_edges={n_cut}, split_across={n_orient})"
            return None
        dev = data_a.points.device
        merged, mm = merge_children(
            data_a, data_b,
            (data_a.points[torch.as_tensor(ta, device=dev)], data_b.points[torch.as_tensor(tb, device=dev)], ta, tb),
            self.options.merge, meta=meta,
        )
        if merged is None:
            self._last_merge_fail = "sim3_failed(pairs=%d inl=%d)" % (len(ta), int(mm.get("sim3_inliers", 0)))
            return None
        # the (image, keypoint) -> track map of the merged scene: only the
        # Sim3-inlier pairs were fused, so only they map b's tracks onto a's
        # (the children own disjoint cameras, so each (image, keypoint)
        # lives in one map)
        inl = mm["sim3_inlier_mask"]
        nb = data_b.max_tracks
        lut = np.arange(nb, dtype=np.int64) + data_a.max_tracks
        lut[tb[inl]] = ta[inl]
        new_map = np.where(map_b >= 0, lut[np.clip(map_b, 0, nb - 1)], map_a)
        # merge_children compacted the merged track axis: compose its map
        o2n = mm["track_old2new"]
        new_map = np.where(new_map >= 0, o2n[np.clip(new_map, 0, len(o2n) - 1)], -1)
        return merged, new_map.astype(np.int32)
