"""CLI entry point.

Port of gtsfm_tpu/runner.py, with the same flags:

    python -m gtsfm_tpu_torch.runner --config_name unified \\
        --loader olsson --dataset_dirpath <dir> [--output_root <out>] \\
        [scene_optimizer.device=cpu mvo.ba.max_iterations=50 ...]

The named configs are the port's copies in configs/: ``unified`` (the
default: DoG-SIFT, the fused mutual-NN matcher, the tiny descriptor),
``deep_front_end`` (SuperPoint, LightGlue, NetVLAD, the joint retriever),
``megaloc_sift_frontend`` (MegaLoc retrieval, DoG-SIFT at K=5000),
``onedsfm_front_end`` (NetVLAD retrieval, DoG-SIFT), the feed-forward
slots ``vggt``, ``fastvggt`` and ``anysplat`` (the compact model by
default; ``scene_optimizer.feedforward_backbone=vggt_exact
scene_optimizer.vggt_weights_path=<file>`` for VGGT in the public
VGGT-1B layout), and the others there.
A learned net takes its checkpoint by override
(``detector.weights_path=superpoint_v1.pth``,
``matcher.weights_path=superpoint_lightglue.pth``,
``global_descriptor.weights_path=megaloc.torch``); without one it runs on
its seeded random init. The registry also builds the ``d2net`` and
``disk`` detectors and the ``hloc_netvlad`` descriptor.

The run goes to the CUDA card unless an override sets
``scene_optimizer.device=cpu``. All nine ``--loader`` choices work, as do
``--run_gs``, ``--hierarchical``, ``--cluster_optimizer``, ``--run_mvs``
with ``--mvs_backend plane_sweep|patchmatchnet`` (PatchmatchNet needs
``--mvs_weights_path``, a checkpoint in the official model_000007.ckpt
layout) and ``--bal PROBLEM`` (bundle adjustment alone on a BAL file, on
the card unless ``scene_optimizer.device=cpu``; the COLMAP text goes to
``<output_root>/bal_output``), ``--use_cache`` with ``--cache_root`` (disk
caches of the detector, global descriptor, learned matcher, two-view and
cluster stages; the default root is ``~/.cache/gtsfm_tpu_torch``),
``--load_chunk_size`` (load and detect that many images at a time),
``--prewarm`` (build the CUDA kernels and warm the standard shapes before
the run, ``utils/prewarm.py``), ``--gs_video_frames`` (the splats'
fly-through) and ``--compare_to`` (the exported reconstruction against a
COLMAP directory, written to ``<output_root>/results/comparison/``).

``--distributed_coordinator host:port --distributed_num_processes N
--distributed_process_id I`` runs the process as rank I of an N-rank
``torch.distributed`` job (``maybe_init_distributed``, before any work):
every rank runs the same command with its own id, the ranks form a (data,
model) mesh (parallel/sharding.py) over which the two-view chunks, the
matcher's desc1 rows and BA's measurements are sharded, and every rank
computes the same reconstruction; only rank 0 writes the run's files (the
results under ``--output_root``, the telemetry database, ``--compare_to``'s
tables and ``--bal``'s export). Caches are read and written by every rank:
give each rank its own ``--cache_root``. Rank 0's coordinator address is
the ``tcp://`` rendezvous.
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
                   help="BA-only mode: optimize a BAL problem file, print the costs, export COLMAP text")
    p.add_argument("--compare_to", default=None, metavar="COLMAP_DIR",
                   help="compare the exported reconstruction against this COLMAP directory")
    p.add_argument("--loader", default="olsson", choices=list(_LOADERS))
    p.add_argument("--dataset_dirpath", default=None, help="dataset root")
    p.add_argument("--images_dir", default=None, help="colmap loader images dir")
    p.add_argument("--colmap_files_dirpath", default=None)
    p.add_argument("--argoverse_log_id", default=None, help="argoverse vehicle log id")
    p.add_argument("--max_resolution", type=int, default=760)
    p.add_argument("--max_frames", type=int, default=None)
    p.add_argument("--output_root", default="results")
    p.add_argument("--run_mvs", action="store_true", help="dense MVS after the sparse reconstruction")
    p.add_argument("--run_gs", action="store_true", help="gaussian splatting")
    p.add_argument("--mvs_backend", default="plane_sweep", choices=["plane_sweep", "patchmatchnet"])
    p.add_argument("--mvs_weights_path", default=None, help="PatchmatchNet checkpoint (official layout)")
    p.add_argument("--gs_video_frames", type=int, default=0,
                   help="render a camera-path PNG sequence and GIF of the splats")
    p.add_argument("--hierarchical", action="store_true", help="partitioned reconstruction")
    p.add_argument("--cluster_optimizer", default=None, choices=["mvo", "vggt", "fastvggt", "anysplat"],
                   help="reconstruction engine: mvo, or a feed-forward slot")
    p.add_argument("--use_cache", action="store_true",
                   help="disk caches of the detector, descriptor, matcher, two-view and cluster stages")
    p.add_argument("--cache_root", default=None)
    p.add_argument("--load_chunk_size", type=int, default=None,
                   help="load and detect N images at a time (bounds host memory)")
    p.add_argument("--distributed_coordinator", default=None,
                   help="host:port of process 0 (enables torch.distributed)")
    p.add_argument("--distributed_num_processes", type=int, default=None)
    p.add_argument("--distributed_process_id", type=int, default=None)
    p.add_argument("--prewarm", action="store_true",
                   help="build the CUDA kernels and warm the standard shapes before the run")
    p.add_argument("overrides", nargs="*", help="dotted key=value config overrides")
    return p


def maybe_init_distributed(args, device: str = "cuda") -> bool:
    """Join the ``torch.distributed`` job that the ``--distributed_*`` flags
    name, before any work; returns True when it did, False without a
    coordinator. The backend follows ``parallel.sharding.backend_for``:
    NCCL when each rank of the host has a card of its own (rank r on
    ``cuda:r``; LOCAL_RANK and LOCAL_WORLD_SIZE, when set, give the rank's
    place on a host of several), Gloo when ranks share a card or the run is
    on the CPU. Each rank keeps its share of the host's CPU threads.

    Parity: the reference's ``jax.distributed.initialize`` bring-up
    (gtsfm_tpu/runner.py ``maybe_init_distributed``)."""
    if args.distributed_coordinator is None:
        return False
    if args.distributed_num_processes is None or args.distributed_process_id is None:
        raise ValueError("--distributed_coordinator needs --distributed_num_processes and --distributed_process_id")
    import torch
    import torch.distributed as dist

    from gtsfm_tpu_torch.parallel.sharding import backend_for
    from gtsfm_tpu_torch.utils.numerics import resolve_device

    world, rank = args.distributed_num_processes, args.distributed_process_id
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev_type = resolve_device(device).type
    cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    backend = backend_for(dev_type, per_host, cards)
    if dev_type == "cuda":
        torch.cuda.set_device(local_rank % cards)
    torch.set_num_threads(max(1, min(torch.get_num_threads(), (os.cpu_count() or 1) // per_host)))
    where = f"cuda:{local_rank % cards} of {cards} card(s)" if dev_type == "cuda" else "the CPU"
    why = ("a card per rank" if backend == "nccl" else
           f"{per_host} ranks on {cards} card(s)" if dev_type == "cuda" else "the CPU")
    print(f"distributed: rank {rank} of {world} on {where}, backend {backend} ({why})", flush=True)
    dist.init_process_group(backend=backend, init_method=f"tcp://{args.distributed_coordinator}",
                            world_size=world, rank=rank)
    return True


def build_loader(args):
    kw = dict(max_resolution=args.max_resolution, max_frames=args.max_frames)
    if args.loader == "olsson":
        from gtsfm_tpu_torch.loader.olsson import OlssonLoader

        return OlssonLoader(args.dataset_dirpath, **kw)
    if args.loader == "astrovision":
        from gtsfm_tpu_torch.loader.datasets import AstrovisionLoader

        return AstrovisionLoader(args.dataset_dirpath, **kw)
    if args.loader == "tanks_and_temples":
        from gtsfm_tpu_torch.loader.datasets import TanksAndTemplesLoader

        base = args.dataset_dirpath
        name = os.path.basename(base.rstrip("/"))
        return TanksAndTemplesLoader(img_dir=args.images_dir or os.path.join(base, name),
                                     poses_fpath=os.path.join(base, f"{name}_COLMAP_SfM.log"), **kw)
    if args.loader == "mobilebrick":
        from gtsfm_tpu_torch.loader.datasets import MobilebrickLoader

        return MobilebrickLoader(args.dataset_dirpath, **kw)
    if args.loader == "onedsfm":
        from gtsfm_tpu_torch.loader.datasets import OneDSFMLoader

        return OneDSFMLoader(args.dataset_dirpath, **kw)
    if args.loader == "hilti":
        from gtsfm_tpu_torch.loader.hilti import HiltiLoader

        return HiltiLoader(args.dataset_dirpath, **kw)
    if args.loader == "argoverse":
        from gtsfm_tpu_torch.loader.datasets import ArgoverseLoader

        log_id = args.argoverse_log_id
        if log_id is None:
            logs = sorted(d for d in os.listdir(args.dataset_dirpath)
                          if os.path.isdir(os.path.join(args.dataset_dirpath, d)))
            if not logs:
                raise ValueError("no argoverse logs under dataset_dirpath")
            log_id = logs[0]
        return ArgoverseLoader(args.dataset_dirpath, log_id=log_id, max_num_imgs=args.max_frames or 20,
                               max_resolution=args.max_resolution)
    if args.loader == "yfcc":
        from gtsfm_tpu_torch.loader.datasets import YfccImbLoader

        return YfccImbLoader(args.dataset_dirpath, max_resolution=args.max_resolution)
    from gtsfm_tpu_torch.loader.colmap import ColmapLoader

    colmap_dir = args.colmap_files_dirpath or args.dataset_dirpath
    images_dir = args.images_dir or os.path.join(args.dataset_dirpath, "images")
    return ColmapLoader(colmap_dir, images_dir, **kw)


def run_bal(path: str, output_root: str, device="cuda") -> int:
    """BA-only tool mode: read a BAL problem, run bundle adjustment
    (``BAOptions()``, camera 0 fixed) on ``device``, print the problem's
    size and the cost before and after, and export COLMAP text to
    ``<output_root>/bal_output``."""
    import numpy as np

    from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
    from gtsfm_tpu_torch.io import colmap as colmap_io
    from gtsfm_tpu_torch.io.bal import read_bal
    from gtsfm_tpu_torch.utils.numerics import resolve_device

    dev = resolve_device(device)
    data = read_bal(path).map(lambda a: a.to(dev))
    print(f"BAL problem: {data.number_images()} cameras, {data.number_tracks()} points, "
          f"{data.number_measurements()} measurements")
    fixed = np.zeros(data.max_cameras, bool)
    fixed[0] = True
    t0 = time.time()
    out, metrics = BundleAdjustment(BAOptions()).run(data, fixed_cam=fixed)
    print(f"BA: cost {metrics['initial_cost']:.4g} -> {metrics['final_cost']:.4g} "
          f"in {metrics['iterations']} iterations ({time.time() - t0:.1f}s)")
    if output_root:
        colmap_io.write_scene(out, os.path.join(output_root, "bal_output"))
    return 0


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    from gtsfm_tpu_torch.configs.config import load_config

    cfg = load_config(args.config_name, args.overrides)
    so_cfg = cfg.setdefault("scene_optimizer", {})
    joined = maybe_init_distributed(args, so_cfg.get("device", "cuda"))
    try:
        return _run(parser, args, cfg, so_cfg, writes=not joined or args.distributed_process_id == 0)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run(parser, args, cfg: dict, so_cfg: dict, writes: bool) -> int:
    """The run of ``main`` after the distributed bring-up; ``writes``: this
    process writes the run's files (rank 0 or a single process)."""
    from gtsfm_tpu_torch.configs.config import build_scene_optimizer

    if args.bal:
        return run_bal(args.bal, args.output_root if writes else None, so_cfg.get("device", "cuda"))
    if not args.dataset_dirpath:
        parser.error("--dataset_dirpath is required (except with --bal)")
    if args.prewarm:
        from gtsfm_tpu_torch.utils.prewarm import prewarm_standard_shapes

        timings = prewarm_standard_shapes(device=so_cfg.get("device", "cuda"))
        print("prewarm: " + " ".join(f"{k} {v}s" for k, v in timings.items()), flush=True)
    so_cfg["output_root"] = args.output_root if writes else None
    if not writes:
        so_cfg["telemetry_db"] = None
    if args.run_mvs:
        so_cfg["run_mvs"] = True
    if args.mvs_backend != "plane_sweep":
        so_cfg["mvs_backend"] = args.mvs_backend
        so_cfg["mvs_weights_path"] = args.mvs_weights_path
    if args.run_gs:
        so_cfg["run_gs"] = True
    if args.gs_video_frames:
        so_cfg["gs_video_frames"] = args.gs_video_frames
    if args.hierarchical:
        so_cfg["hierarchical"] = True
    if args.cluster_optimizer:
        so_cfg["cluster_optimizer"] = args.cluster_optimizer
    if args.use_cache:
        so_cfg["use_cache"] = True
    if args.cache_root:
        so_cfg["cache_root"] = args.cache_root
    if args.load_chunk_size is not None:
        so_cfg["load_chunk_size"] = args.load_chunk_size
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
    if args.compare_to and writes:
        compare_to(args.output_root, args.compare_to)
    return 0


def compare_to(output_root: str, ref_dir: str) -> None:
    """Compare ``<output_root>/results/ba_output`` with the COLMAP directory
    ``ref_dir``; the tables and plot go to ``<output_root>/results/comparison``
    and the scalars are printed."""
    from gtsfm_tpu_torch.evaluation.compare import compare_colmap_dirs

    est_dir = os.path.join(output_root, "results", "ba_output")
    if not os.path.exists(os.path.join(est_dir, "cameras.txt")):
        print("  comparison skipped: no exported reconstruction")
        return
    cg = compare_colmap_dirs(est_dir, ref_dir, output_dir=os.path.join(output_root, "results", "comparison"))
    for m in cg.metrics:
        if m.dist is None:
            print(f"  comparison/{m.name}: {m.scalar}")


if __name__ == "__main__":
    sys.exit(main())
