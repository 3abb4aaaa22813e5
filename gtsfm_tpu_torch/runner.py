"""CLI entry point.

Port of gtsfm_tpu/runner.py, with the same flags:

    python -m gtsfm_tpu_torch.runner --config_name unified \\
        --loader olsson --dataset_dirpath <dir> [--output_root <out>] \\
        [scene_optimizer.device=cpu mvo.ba.max_iterations=50 ...]

The named configs are the port's copies in configs/: ``unified`` (the
default: DoG-SIFT, the fused mutual-NN matcher, the tiny descriptor),
``deep_front_end`` (SuperPoint, LightGlue, NetVLAD, the joint retriever),
``megaloc_sift_frontend`` (MegaLoc retrieval, DoG-SIFT at K=5000),
``onedsfm_front_end`` (NetVLAD retrieval, DoG-SIFT), and the others there.
A learned net takes its checkpoint by override
(``detector.weights_path=superpoint_v1.pth``,
``matcher.weights_path=superpoint_lightglue.pth``,
``global_descriptor.weights_path=megaloc.torch``); without one it runs on
its seeded random init. The registry also builds the ``d2net`` and
``disk`` detectors and the ``hloc_netvlad`` descriptor.

The run goes to the CUDA card unless an override sets
``scene_optimizer.device=cpu``. ``--loader olsson`` and ``--loader colmap``
work, as do ``--run_gs`` and ``--hierarchical``. The flags whose modules
are not ported yet (the other loaders, ``--bal``, ``--compare_to``,
``--run_mvs``, ``--cluster_optimizer``, ``--use_cache``,
``--load_chunk_size``, ``--prewarm``, ``--gs_video_frames`` and the
``--distributed_*`` flags) raise ``NotImplementedError`` naming their
ROADMAP item before any work.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

_LOADERS = ("olsson", "colmap", "astrovision", "tanks_and_temples", "mobilebrick", "onedsfm", "hilti",
            "argoverse", "yfcc")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gtsfm_tpu_torch reconstruction runner")
    p.add_argument("--config_name", default="unified", help="named config or YAML path")
    p.add_argument("--bal", default=None, metavar="PROBLEM",
                   help="BA-only mode on a BAL problem file (not ported)")
    p.add_argument("--compare_to", default=None, metavar="COLMAP_DIR",
                   help="compare the exported reconstruction against this COLMAP directory (not ported)")
    p.add_argument("--loader", default="olsson", choices=list(_LOADERS))
    p.add_argument("--dataset_dirpath", default=None, help="dataset root")
    p.add_argument("--images_dir", default=None, help="colmap loader images dir")
    p.add_argument("--colmap_files_dirpath", default=None)
    p.add_argument("--argoverse_log_id", default=None, help="argoverse vehicle log id")
    p.add_argument("--max_resolution", type=int, default=760)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--output_root", default="results")
    p.add_argument("--run_mvs", action="store_true", help="dense plane-sweep MVS (not ported)")
    p.add_argument("--run_gs", action="store_true", help="gaussian splatting")
    p.add_argument("--mvs_backend", default="plane_sweep", choices=["plane_sweep", "patchmatchnet"])
    p.add_argument("--mvs_weights_path", default=None)
    p.add_argument("--gs_video_frames", type=int, default=0,
                   help="render a camera-path PNG sequence of the splats (not ported)")
    p.add_argument("--hierarchical", action="store_true", help="partitioned reconstruction")
    p.add_argument("--cluster_optimizer", default=None, choices=["mvo", "vggt", "fastvggt", "anysplat"],
                   help="per-cluster reconstruction engine (not ported)")
    p.add_argument("--use_cache", action="store_true", help="disk caching of detect / two-view (not ported)")
    p.add_argument("--cache_root", default=None)
    p.add_argument("--load_chunk_size", type=int, default=None, help="stream load + detect (not ported)")
    p.add_argument("--distributed_coordinator", default=None, help="host:port of process 0 (not ported)")
    p.add_argument("--distributed_num_processes", type=int, default=None)
    p.add_argument("--distributed_process_id", type=int, default=None)
    p.add_argument("--prewarm", action="store_true", help="compile ahead of the run (not ported)")
    p.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    return p


def check_ported(args) -> None:
    """Raise NotImplementedError for a flag whose modules are not ported."""
    unported = [
        (args.loader not in ("olsson", "colmap"), f"--loader {args.loader}", 3),
        (args.bal, "--bal", 3),
        (args.compare_to, "--compare_to", 6),
        (args.run_mvs or args.mvs_backend != "plane_sweep" or args.mvs_weights_path, "--run_mvs", 3),
        (args.cluster_optimizer not in (None, "mvo"), "--cluster_optimizer", 3),
        (args.use_cache or args.cache_root, "--use_cache", 3),
        (args.load_chunk_size is not None, "--load_chunk_size", 3),
        (args.prewarm, "--prewarm", 3),
        (args.distributed_coordinator or args.distributed_num_processes is not None
         or args.distributed_process_id is not None, "--distributed_*", 3),
        (args.gs_video_frames, "--gs_video_frames", 5),
    ]
    for hit, flag, item in unported:
        if hit:
            raise NotImplementedError(f"{flag} is not ported yet (ROADMAP queue 1 item {item})")


def build_loader(args):
    kw = dict(max_resolution=args.max_resolution, max_frames=args.max_frames)
    if args.loader == "olsson":
        from gtsfm_tpu_torch.loader.olsson import OlssonLoader

        return OlssonLoader(args.dataset_dirpath, **kw)
    from gtsfm_tpu_torch.loader.colmap import ColmapLoader

    colmap_dir = args.colmap_files_dirpath or args.dataset_dirpath
    images_dir = args.images_dir or os.path.join(args.dataset_dirpath, "images")
    return ColmapLoader(colmap_dir, images_dir, **kw)


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    check_ported(args)
    if not args.dataset_dirpath:
        parser.error("--dataset_dirpath is required")
    from gtsfm_tpu_torch.configs.config import build_scene_optimizer, load_config

    cfg = load_config(args.config_name, args.overrides)
    so_cfg = cfg.setdefault("scene_optimizer", {})
    so_cfg["output_root"] = args.output_root
    if args.run_gs:
        so_cfg["run_gs"] = True
    if args.hierarchical:
        so_cfg["hierarchical"] = True
    so = build_scene_optimizer(cfg)
    loader = build_loader(args)
    t0 = time.time()
    data, groups = so.run(loader)
    print(f"reconstruction finished in {time.time() - t0:.1f}s")
    print(f"cameras: {data.number_images()}  tracks: {data.number_tracks()}  "
          f"measurements: {data.number_measurements()}")
    for g in groups:
        for k, v in g.to_dict()[g.name].items():
            if isinstance(v, (int, float)):
                print(f"  {g.name}/{k}: {v}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
