"""The essential polish on the card, eagerly and as CUDA graph replays.

    python scripts/polish_graph_probe.py [--pairs 256 114] [--keypoints 2048]

For each chunk size and each of the verifier's iteration counts (8 in
RANSAC's polish rounds, 6 in the two-view refine), on seeded
correspondences with outliers: the eager loop's host time a call (it ends
in a synchronization); the first graph call's time (warm-up, capture,
replay); a replay's device time by CUDA events over 20 replays and the
host time of ``_refine_essential``'s replay path; the kernels of one eager
iteration and of one replay (``torch.profiler``, the card's activity), the
solver's kernels by name; bit-equality of the replay with the eager loop;
and the shared graph pool's bytes. Prints one JSON object. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gtsfm_tpu_torch.frontend.verifiers import essential  # noqa: E402
from gtsfm_tpu_torch.geometry import so3  # noqa: E402
from gtsfm_tpu_torch.utils.numerics import precise  # noqa: E402

SOLVER_WORDS = ("getrf", "getrs", "trsm", "lu", "magma", "solve", "pivot")


def inputs(P: int, K: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    pts = torch.rand((P, K, 3), generator=g) * torch.tensor([4.0, 4.0, 4.0]) + torch.tensor([-2.0, -2.0, 4.0])
    R = so3.expmap(0.15 * torch.randn((P, 3), generator=g))
    t = torch.tensor([1.0, 0.1, 0.2]) + 0.1 * torch.randn((P, 3), generator=g)
    p2 = torch.einsum("pij,pkj->pki", R, pts) + t[:, None]
    x1 = pts[..., :2] / pts[..., 2:] + 1e-3 * torch.randn((P, K, 2), generator=g)
    x2 = p2[..., :2] / p2[..., 2:] + 1e-3 * torch.randn((P, K, 2), generator=g)
    out = torch.rand((P, K), generator=g) < 0.2
    x2 = torch.where(out[..., None], torch.rand((P, K, 2), generator=g) - 0.5, x2)
    w = ((torch.rand((P, K), generator=g) > 0.1) & ~out).float()
    R0 = R @ so3.expmap(0.02 * torch.randn((P, 3), generator=g))
    t0 = t + 0.05 * torch.randn((P, 3), generator=g)
    t0 = t0 / torch.linalg.vector_norm(t0, dim=-1, keepdim=True)
    return tuple(a.cuda() for a in (x1, x2, w, R0, t0, torch.full((P,), 4.0 / 600)))


def kernels(fn) -> list:
    """Names of the device kernels ``fn()`` launches."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.name.startswith(("Memcpy", "Memset"))]


def pool_bytes() -> int:
    pools = {tuple(p) for p in essential._PolishGraph.pools.values()}
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s.get("segment_pool_id", (0, 0))) in pools)


def probe(P: int, K: int, iters: int, seed: int) -> dict:
    a = inputs(P, K, seed)
    b = inputs(P, K, seed + 1)
    call = lambda args: essential._refine_essential(*args[:5], iters, 2.0, args[5])  # noqa: E731
    eager_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        R_e, t_e = essential._refine_loop(*b[:5], iters, 2.0, b[5])
        torch.cuda.synchronize()
        eager_s.append(time.perf_counter() - t0)
    captures = essential.POLISH_GRAPH_CAPTURES
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    call(a)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    R_g, t_g = call(b)
    equal = bool(torch.equal(R_g, R_e) and torch.equal(t_g, t_e))
    key = essential._polish_key(a, iters, 2.0)
    graph = essential._POLISH_GRAPHS.entries[key]
    n = 20
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        graph.graph.replay()
    end.record()
    torch.cuda.synchronize()
    replay_device_ms = start.elapsed_time(end) / n
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        call(b)
    host_ms = (time.perf_counter() - t0) / n * 1e3
    torch.cuda.synchronize()
    call_ms = (time.perf_counter() - t0) / n * 1e3
    one_iter = kernels(lambda: essential._refine_loop(*b[:5], 1, 2.0, b[5]))
    replay = kernels(graph.graph.replay)
    return {"P": P, "K": K, "iters": iters, "bit_equal": equal,
            "captured": essential.POLISH_GRAPH_CAPTURES - captures,
            "eager_call_ms": [round(s * 1e3, 3) for s in eager_s], "first_graph_call_ms": round(first_s * 1e3, 3),
            "replay_device_ms": round(replay_device_ms, 4), "replay_call_host_ms": round(host_ms, 4),
            "replay_call_synced_ms": round(call_ms, 4),
            "kernels_per_eager_iteration": len(one_iter), "kernels_per_replay": len(replay),
            "solver_kernels": sorted({k for k in replay if any(w in k.lower() for w in SOLVER_WORDS)})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, nargs="+", default=[256, 114])
    ap.add_argument("--keypoints", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    rows = []
    with precise():
        for P in args.pairs:
            for iters in (8, 6):
                rows.append(probe(P, args.keypoints, iters, seed=P * 10 + iters))
    rows_eager = [statistics.median(r["eager_call_ms"]) for r in rows]
    print(json.dumps({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                      "captures": essential.POLISH_GRAPH_CAPTURES, "replays": essential.POLISH_GRAPH_REPLAYS,
                      "eager_calls": essential.POLISH_EAGER_CALLS, "pool_bytes": pool_bytes(),
                      "eager_call_ms_median": rows_eager, "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
