"""CPU tests of the feed-forward pipeline (perfbench/pipelines/feedforward.py)
and its cell, ``vggt1b.cluster16``, through run.run_cell at a tiny size:
the configuration's checkpoint at a few channels (all 24 layer pairs,
whose layers 4, 11, 17 and 23 the heads read), 3-view clusters of an
8-view loop at 96 x 72, taken in at 75 x 56.

    python -m pytest perfbench/tests -q -p no:cacheprovider

They check the result line's keys, that a sound run is correct, that a
fault planted in the program's model fails the check, the operation
counts against torch's own count of the reference, and the new entries
of BENCHMARK.json against the benchmark's contract.
"""

from __future__ import annotations

import json
import re

import pytest
import torch

from perfbench import run, vggt_weights
from perfbench.counts import vggt as counts
from perfbench.pipelines import feedforward
from perfbench.reference import vggt as reference

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
CELL = "vggt1b.cluster16"
TINY_MODEL = {"embed_dim": 32, "num_heads": 2, "dino_depth": 2, "dino_heads": 2, "dino_pretrain_grid": 4,
              "camera_trunk_depth": 1, "dpt_features": 16, "dpt_out_channels": [8, 16, 32, 32],
              "track.latent_dim": 16, "track.hidden_size": 32, "track.corr_levels": 3, "track.corr_radius": 2,
              "track.depth": 2, "track.num_virtual_tracks": 4, "track.dpt_features": 16}
TINY_TRAFFIC = {"views": 8, "width": 96, "height": 72, "focal_px": 84.0, "supersample": 1, "max_resolution": 56,
                "cluster_views": 3}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def tiny_run(**kw):
    return run.run_cell(BENCH, CELL, 2**31 + 77, kw.pop("seconds", 1e-3), False, device="cpu",
                        overrides=TINY_MODEL, traffic_override=TINY_TRAFFIC, **kw)


def test_sound_run_is_correct_with_the_contract_keys():
    res = tiny_run(seconds=0.5)
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert set(res["metrics"]) == {"views_per_s", "peak_gib", "setup_s"}
    assert res["metrics"]["views_per_s"]["unit"] == "views/s" and res["metrics"]["views_per_s"]["value"] > 0
    assert list(res["checks"]) == list(feedforward.Pipeline.ORDER)
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] % TINY_TRAFFIC["cluster_views"] == 0 and res["attempted"] >= 3


def _model(so):
    from gtsfm_tpu_torch.scene import cluster_feedforward

    return next(m for k, m in cluster_feedforward._MODEL_CACHE.items() if k[0] == "vggt_exact")


def _global_in_one_frame(so):
    net = _model(so).net
    C = net.opts.embed_dim
    for blk in net.aggregator.global_blocks:
        blk.forward = lambda x, pos, freq, inner=blk.forward: inner(
            x.reshape(TINY_TRAFFIC["cluster_views"], -1, C), pos[: x.shape[1] // TINY_TRAFFIC["cluster_views"]],
            freq).reshape(1, -1, C)


def _depth_head_altered(so):
    with torch.no_grad():
        _model(so).net.depth_head.scratch.output_conv2[2].bias[0] += 1e-2


def _track_head_altered(so):
    with torch.no_grad():
        _model(so).net.track_head.tracker.vis_predictor[0].bias += 1.0


@pytest.mark.parametrize("fault", [_global_in_one_frame, _depth_head_altered, _track_head_altered],
                         ids=["global_attention_in_one_frame", "depth_head_altered", "track_head_altered"])
def test_check_fails_a_broken_model(fault):
    assert tiny_run(fault=fault)["correct"] is False


def test_pass_counts_match_torchs_count_of_the_reference():
    from torch.utils.flop_counter import FlopCounterMode

    model = feedforward.with_overrides(run.load_json(run.HERE, "configs", "vggt1b.json"), TINY_MODEL)["model"]
    model["depth"], model["intermediate_layer_idx"] = 3, [0, 1, 2, 2]
    net = reference.VGGT(reference.dims_from(model))
    net.load_state_dict(vggt_weights.draw(model, 3, "cpu"))
    net.eval().requires_grad_(False)
    S, H, W, N = 3, 64, 80, 5
    with FlopCounterMode(display=False) as flops, torch.no_grad():
        net.products(torch.rand(S, 3, H, W))
        net.tracks(torch.rand(S, 3, H, W), torch.rand(N, 2) * 50)
    assert flops.get_total_flops() == counts.pass_flops(model, S, H, W, N)


def test_attention_count_at_small_shapes():
    # 2 sequences of 3 tokens at width 4: 4 * 6 * 3 * 4 operations, q, k, v and out of 6 x 4 float32
    assert counts.attention_work(6, 3, 4) == (4 * 6 * 3 * 4, 4 * 6 * 4 * 4)


def test_new_entries_follow_the_contract():
    conf = next(c for c in BENCH["configs"] if c["name"] == "vggt1b")
    cell = next(w for w in BENCH["workloads"] if w["name"] == CELL)
    assert set(conf) == {"name", "source", "file", "reduced", "why"} and conf["reduced"] == []
    assert set(cell) == {"name", "config", "traffic", "chips", "why"} and cell["chips"] == 1
    assert all(0 < len(x["why"]) <= 200 and "\n" not in x["why"] for x in (conf, cell))
    new = [m for m in BENCH["per_layer"] if CELL in m.get("workloads", [])]
    assert {m["name"] for m in new} == {"vggt_global_ms_per_pass", "vggt_frame_ms_per_pass", "vggt_dino_ms_per_pass",
                                        "vggt_heads_ms_per_pass", "post_ba_ms_per_pass", "vggt_attention_roofline",
                                        "vggt_mfu"}
    for m in new:
        assert NAME.match(m["name"]) and m["moves"] == "views_per_s" and m["workloads"] == [CELL]
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    configured = run.load_json(run.HERE, "configs", "vggt1b.json")
    assert configured["name"] == "vggt1b" and configured["reduced"] == [] and configured["pipeline"] == "feedforward"
    limits = run.load_json(run.HERE, "workloads", f"{CELL}.json")
    assert set(limits["limits"]) == set(feedforward.Pipeline.ORDER) and limits["limits"]["views_missing"] == 0
    assert set(limits["why"]) == set(feedforward.Pipeline.ORDER)
    assert len(json.dumps(BENCH)) < 64 * 1024
