#!/usr/bin/env python3
"""What limits the PyTorch port's splat compositing kernel on a card.

    python3 scripts/composite_limits.py [--parent SRC.cu]

Run from the root of a checkout on a machine with a CUDA card and nvcc. At
chip_smoke.py's composite shape (the 50,000-gaussian splat scene from ring
camera 0 at 480x640: 1200 tiles x cap 512) it prints, after the card's name,
power limit and top SM clock (nvidia-smi):
- the share of the evaluated (slot, pixel group) pairs where no pixel of
  the group has q < 16, for groups of 16, 8, 4 and 2 rows: what the
  kernel's per-warp slot test can drop;
- for each build (the kernel as committed; without the slot test,
  -DGTSFM_COMPOSITE_NO_CULL; 2 and 8 pixels per thread; ``--parent``,
  another source of the same C interface, e.g. an earlier commit's):
  registers and shared memory (ptxas), the innermost loop holding the ex2
  instructions (cuobjdump) as instructions per pixel-slot (per ex2) and by
  opcode, and its max abs error against the plain version;
- the host time of one composite_tiles call;
- each build's device time: a CUDA graph of 5 calls, median of 20 replays
  (CUDA events), in turns, beside chip_smoke.py's way (5 calls back to
  back, which also holds the host's time of the first call), on the tiles
  in order and permuted longest first (by live slots), with the share of
  the bound and the issue floor of its loop (its instructions per
  pixel-slot x evaluated pixel-slots over 4 warp instructions per clock
  per SM); and what the longest-first sort costs on the card;
- from builds with -DGTSFM_COMPOSITE_CLOCKS (the committed one and PIX 2):
  the 132, 264 and 528 longest tiles alone (1, 2, 4 per SM), a warp's
  clocks per kept slot; and one call on all tiles: the kernel's span, each
  SM's busy span, tiles per SM, and for the 20 longest tiles where a warp's
  clocks go (staging, compositing, stop checks) and its kept slots.
The full SASS of each build goes to build/torch_kernels/composite_sass_<build>.txt.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SOURCE = os.path.join(ROOT, "gtsfm_tpu_torch", "csrc", "splat_composite.cu")
ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3


def build(name: str, source: str, *flags):
    """nvcc ``source`` into build/torch_kernels/lib<name>.so with ``flags``;
    returns (ctypes library, ptxas register / shared-memory lines)."""
    from gtsfm_tpu_torch.utils import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(cuda_build.BUILD_DIR, f"lib{name}.so")
    log = subprocess.run([cuda_build._nvcc(), "-Xptxas", "-v", "-gencode", "arch=compute_90a,code=sm_90a",
                          "-std=c++17", "-O3", *flags, "-shared", "-Xcompiler", "-fPIC", "-o", lib, source],
                         capture_output=True, text=True, check=True)
    regs = " ".join(line.strip() for line in (log.stdout + log.stderr).splitlines() if "registers" in line or "spill" in line)
    return ctypes.CDLL(lib), lib, regs


def hot_loop(lib_path: str, name: str):
    """(instructions per ex2 in the innermost loop holding ex2s, its length,
    its opcode counts); writes the full SASS beside the library."""
    from gtsfm_tpu_torch.utils import cuda_build

    cuobjdump = os.path.join(os.path.dirname(cuda_build._nvcc()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True).stdout
    with open(os.path.join(os.path.dirname(lib_path), f"composite_sass_{name}.txt"), "w") as f:
        f.write(sass)
    instr = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
    ops = [(int(m.group(1), 16), m.group(3), m.group(4)) for m in map(instr.search, sass.splitlines()) if m]
    ex2 = [a for a, op, _ in ops if op.startswith("MUFU.EX2")]
    loops = []  # (start, end) of every backward branch around an ex2
    for a, op, rest in ops:
        target = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
        if target and int(target.group(1), 16) < a and any(int(target.group(1), 16) <= e <= a for e in ex2):
            loops.append((int(target.group(1), 16), a))
    if not loops:
        return float("nan"), 0, {}
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    body = [op for a, op, _ in ops if lo <= a <= hi]
    n_ex2 = sum(op.startswith("MUFU.EX2") for op in body)
    hist = collections.Counter(op.split(".")[0] for op in body)
    return len(body) / n_ex2, len(body), dict(hist.most_common())


def culling(packed, gidx, counts, origins, need):
    """Of the evaluated (slot, pixel group) pairs, the share where no pixel
    of the group has q < 16 (the slot adds nothing there), for groups of 16,
    8, 4 and 2 rows of a tile; and evaluated slots per tile."""
    import torch

    n_tiles, cap = gidx.shape
    pix = torch.arange(256, device=gidx.device)
    share = {rows: [0, 0] for rows in (16, 8, 4, 2)}
    for t0 in range(0, n_tiles, 64):
        sl = slice(t0, min(t0 + 64, n_tiles))
        a = packed[gidx[sl].long()]  # (n, cap, 9)
        px = origins[sl, 0, None].float() + (pix % 16)[None, :].float()  # (n, 256)
        py = origins[sl, 1, None].float() + (pix // 16)[None, :].float()
        dx = px[:, None, :] - a[..., 0, None]
        dy = py[:, None, :] - a[..., 1, None]
        q = a[..., 6, None] * dx * dx + 2.0 * a[..., 7, None] * dx * dy + a[..., 8, None] * dy * dy
        hit = (q < 16.0) & (a[..., 2, None] > 0)
        live = torch.arange(cap, device=gidx.device)[None, :] < need[sl, None]  # (n, cap)
        for rows in share:
            g = hit.view(hit.shape[0], cap, 16 // rows, rows * 16).any(dim=-1)  # (n, cap, groups)
            share[rows][0] += int((~g & live[..., None]).sum())
            share[rows][1] += int(live.sum()) * (16 // rows)
    q50, q90, mx = (float(x) for x in torch.quantile(need.float(), torch.tensor([0.5, 0.9, 1.0], device=need.device)))
    print("culling: evaluated (slot, group) pairs with no pixel at q < 16: "
          + ", ".join(f"groups of {r} rows {c / n:.3f}" for r, (c, n) in share.items())
          + f" | evaluated slots per tile median {q50:.0f}, 90% {q90:.0f}, max {mx:.0f}; tiles with 512: "
          f"{int((need == 512).sum())}", flush=True)


def main() -> int:
    import torch

    import chip_smoke as cs
    from gtsfm_tpu_torch.loader.synthetic import spectral_ring_poses
    from gtsfm_tpu_torch.splat import rendering
    from gtsfm_tpu_torch.splat.gs_data import GSData
    from gtsfm_tpu_torch.utils.numerics import precise

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", help="another splat_composite.cu with the same C interface, timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("composite_limits: no CUDA device found")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_hz = float(smi.split(",")[-1].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    builds = {"committed": (SOURCE,), "no_cull": (SOURCE, "-DGTSFM_COMPOSITE_NO_CULL"),
              "pix2": (SOURCE, "-DGTSFM_COMPOSITE_PIX=2"), "pix8": (SOURCE, "-DGTSFM_COMPOSITE_PIX=8")}
    if args.parent:
        builds["parent"] = (args.parent,)
    fns, loops = {}, {}
    for name, (src, *flags) in builds.items():
        lib, path, regs = build(f"composite_{name}", src, *flags)
        fn = lib.gtsfm_splat_composite
        fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
        fns[name] = fn
        loops[name] = hot_loop(path, name)
        per, n, hist = loops[name]
        print(f"build {name}: {regs} | hot loop {n} instructions, {per:.2f} per pixel-slot (per ex2) | {hist}",
              flush=True)

    dev = torch.device("cuda")
    n_cam = cs.NUM_CAMERAS
    gt = spectral_ring_poses(cs.ring_pairs(n_cam), n_cam)
    R, t = gt.R.numpy(), gt.t.numpy()
    h, w = cs.SPLAT_HW
    fields = cs.splat_scene(np.asarray(t).mean(axis=0), n=cs.SPLAT_GAUSSIANS)
    scene = GSData(**{k: torch.as_tensor(v, device=dev) for k, v in fields.items()})
    with torch.no_grad(), precise():
        packed, gidx, counts, origins = rendering.bin_tiles(scene, *cs.splat_camera(R, t, 0, dev), h, w)
        want = rendering.composite_tiles_plain(*rendering._gather_attrs_f32(packed, gidx, counts), origins,
                                               rendering.KERNEL_TILE)
        need = cs.evaluated_slots(packed, gidx, counts, origins)
    culling(packed, gidx, counts, origins, need)
    order = torch.argsort(counts, descending=True, stable=True)
    inputs = {"tile order": (packed, gidx, counts, origins),
              "longest first": (packed, gidx[order].contiguous(), counts[order].contiguous(),
                                origins[order].contiguous())}
    saved = rendering._kernel

    def call(name, which):
        rendering._kernel = lambda: fns[name]
        try:
            return rendering.composite_tiles(*inputs[which], rendering.KERNEL_TILE)
        finally:
            rendering._kernel = saved

    for name in fns:
        for which in inputs:
            got = call(name, which)
            if which == "longest first":
                inv = torch.empty_like(order)
                inv[order] = torch.arange(len(order), device=dev)
                got = (got[0][inv], got[1][inv])
            err = max(float((g - w_).abs().max()) for g, w_ in zip(got, want))
            print(f"check {name} ({which}): max abs err {err:.4g} against the plain version", flush=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        call("committed", "tile order")
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    print(f"host time of one composite_tiles call at this shape (200 calls, no synchronize): {host_ms:.4f} ms",
          flush=True)
    runs = []
    turns = list(fns) + list(fns)[::-1]
    with torch.no_grad():
        for name in turns:
            for which in inputs:
                runs.append(((name, which), cs._graph_ms(lambda: call(name, which))))
                runs.append(((name, which + ", wrapper back to back"), cs._median_ms(lambda: call(name, which))))
    sort_ms = cs._graph_ms(lambda: torch.argsort(counts, descending=True, stable=True))
    print(f"the longest-first order on the card, torch.argsort of the {len(counts)} counts: {sort_ms:.4f} ms "
          f"(a CUDA graph of 5 calls)", flush=True)
    bound = cs.composite_bound(packed, need, gidx.shape[0])
    pixel_slots = int(need.sum()) * 256
    for key in dict(runs):
        ms = float(np.median([x for k, x in runs if k == key]))
        per = loops[key[0]][0]
        how = "of 5 calls back to back" if "wrapper" in key[1] else "of a CUDA graph of 5 calls"
        floor_ms = pixel_slots / 32 * per / (4 * sms * clock_hz) * 1e3
        print(f"timing {key[0]} ({key[1]}): {ms:.4f} ms (median of 20 samples {how}, in turns), "
              f"{bound[0] / ms:.3f} of the bound {bound[0]:.4f} ms ({bound[1]}); issue floor of its hot loop "
              f"{floor_ms:.4f} ms ({per:.2f} warp instructions per 32 pixel-slots, 4 per clock per SM at "
              f"{clock_hz / 1e9:.2f} GHz); runs {[round(x, 4) for k, x in runs if k == key]}", flush=True)

    for bname in ("committed", "pix2"):
        schedule(bname, builds[bname], call, fns, inputs, need, order, gidx.shape[0], clock_hz, loops[bname][0],
                 sms)
    return 0


def pix_of(build_args) -> int:
    return next((int(f.split("=")[1]) for f in build_args if f.startswith("-DGTSFM_COMPOSITE_PIX=")), 4)


def schedule(bname, build_args, call, fns, inputs, need, order, n, clock_hz, per, sms):
    """The -DGTSFM_COMPOSITE_CLOCKS build of a build: the longest tiles
    alone, then one call's schedule on each tile order, with the issue floor
    of the (slot, warp) pairs the warps kept (``per`` instructions per
    pixel-slot)."""
    import torch

    src, *flags = build_args
    lib, _path, regs = build(f"composite_clocks_{bname}", src, *flags, "-DGTSFM_COMPOSITE_CLOCKS")
    fn = lib.gtsfm_splat_composite
    fn.argtypes, fn.restype = ARGTYPES, ctypes.c_int
    read = lib.gtsfm_splat_composite_clocks
    read.argtypes, read.restype = [ctypes.c_void_p, ctypes.c_int], ctypes.c_int
    fns["clocks"] = fn
    buf = (ctypes.c_ulonglong * (8 * n))()
    warps = 256 // (32 * pix_of(build_args))
    saved = inputs.get("longest first")
    for per_sm in (1, 2, 4):  # the longest tiles alone: per_sm blocks on each SM
        m = per_sm * sms
        inputs["top"] = tuple(x[:m].contiguous() if x is not saved[0] else x for x in saved)
        call("clocks", "top")
        torch.cuda.synchronize()
        read(ctypes.addressof(buf), n)
        call("clocks", "top")
        torch.cuda.synchronize()
        read(ctypes.addressof(buf), n)
        c = np.array(buf[:], dtype=np.float64).reshape(n, 8)[:m]
        print(f"  the {m} longest tiles alone ({per_sm} per SM): compositing clocks per kept slot per warp "
              f"{c[:, 5].sum() / c[:, 7].sum():.1f}, staging clocks per stage per warp "
              f"{c[:, 4].sum() / (warps * np.ceil(saved[2][:m].cpu().numpy() / 32)).sum():.1f}, span "
              f"{(c[:, 2].max() - c[:, 1].min()) / 1e3:.2f} us", flush=True)
    del inputs["top"]
    for which in inputs:
        call("clocks", which)
        torch.cuda.synchronize()
        if read(ctypes.addressof(buf), n) != 0:  # zeroes the counters
            raise RuntimeError("could not read the composite clocks")
        call("clocks", which)
        torch.cuda.synchronize()
        if read(ctypes.addressof(buf), n) != 0:
            raise RuntimeError("could not read the composite clocks")
        c = np.array(buf[:], dtype=np.float64).reshape(n, 8)
        sm, start, end, ticks = c[:, 0].astype(int), c[:, 1], c[:, 2], c[:, 3]
        phases = c[:, 4:7]  # summed over a tile's warps
        t0 = start.min()
        span = (end.max() - t0) / 1e3
        busy = np.array([(end[sm == s].max() - start[sm == s].min()) / 1e3 for s in np.unique(sm)])
        last = np.array([(end[sm == s].max() - t0) / 1e3 for s in np.unique(sm)])
        tiles = np.bincount(sm)
        slots = (need[order] if which == "longest first" else need).cpu().numpy()
        live = slots > 0
        per_slot = ticks[live] / slots[live]
        big = slots >= 256
        print(f"schedule {bname} ({which}, -DGTSFM_COMPOSITE_CLOCKS build, {regs}): span {span:.2f} us over "
              f"{len(busy)} SMs; SM busy span mean {busy.mean():.2f} min {busy.min():.2f} max {busy.max():.2f} us; "
              f"last block ends mean {last.mean():.2f} max {last.max():.2f} us; tiles per SM {tiles.min()}-"
              f"{tiles.max()}; latest block start {(start.max() - t0) / 1e3:.2f} us; clocks per evaluated slot "
              f"of one tile: median {np.median(per_slot):.1f}, of tiles with >= 256 slots "
              f"{np.median(ticks[big] / slots[big]):.1f}; longest tile {ticks.max() / clock_hz * 1e6:.2f} us "
              f"at the top clock", flush=True)
        kept = c[:, 7].sum()
        floor_ms = kept * 32 * pix_of(build_args) / 32 * per / (4 * sms * clock_hz) * 1e3
        print(f"  kept (slot, warp) pairs {kept:.0f} of {warps * slots.sum():.0f} evaluated "
              f"({kept / (warps * slots.sum()):.3f}): issue floor of the kept pixel-slots {floor_ms:.4f} ms",
              flush=True)
        heavy = np.argsort(-ticks)[:20]
        ph = phases[heavy].sum(axis=0) / (warps * ticks[heavy].sum())
        print(f"  the 20 longest tiles, a warp's share of the tile's clocks: staging (gathered slots awaited) "
              f"{ph[0]:.3f}, compositing {ph[1]:.3f}, stop checks {ph[2]:.3f}; kept slots per warp "
              f"{c[heavy, 7].sum() / (warps * slots[heavy].sum()):.3f} of the evaluated; compositing clocks per kept "
              f"slot per warp {phases[heavy, 1].sum() / c[heavy, 7].sum():.1f}", flush=True)


if __name__ == "__main__":
    sys.exit(main())
