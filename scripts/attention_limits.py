#!/usr/bin/env python3
"""What limits the PyTorch port's attention kernel on a card.

    python3 scripts/attention_limits.py

Run from the root of a checkout on a machine with a CUDA card and nvcc. It
prints, after the card's name and power limit (nvidia-smi):
- the throughput, in thread operations per clock per SM, of the
  instructions the kernel's softmax issues per score (ex2, max, lop3, fma,
  prmt; scripts/attention_limits.cu, one block of 1024 threads per SM);
- from those and the SM clock, the least time the exponentials and the
  tensor-core products each need at LightGlue's shape (P=96 pairs, K=2048,
  4 heads of 64), beside the bound chip_smoke.py reports;
- the host time of one call of fused_attention_merged (tiny inputs), and
  the merged entry's device time at LightGlue's shape timed one call at a
  time (each call synchronized, so the host's work shows) and back to back
  (chip_smoke.py's way), with one scaled_dot_product_attention call timed
  both ways beside it;
- where a consumer warp's pipeline step spends its clocks (waiting for the
  stage and the turn, retiring P V, issuing the products, waiting for S,
  the softmax), from one call at LightGlue's shape of the kernel built with
  -DGTSFM_ATTN_CLOCKS, beside the clocks the SM's tensor cores and
  exponentials need for one step of both consumers.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OPS = ("ex2.approx.ftz.f32", "max.f32", "lop3.b32", "fma.rn.f32", "prmt.b32")
P, K, HEADS, DH = 96, 2048, 4, 64


PHASES = ("stage and turn", "retire P V", "issue", "wait for S", "softmax")


def build(lib_name: str, source: str, *flags):
    from gtsfm_tpu_torch.utils import cuda_build

    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    lib = os.path.join(cuda_build.BUILD_DIR, lib_name)
    subprocess.run([cuda_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", *flags,
                    "-shared", "-Xcompiler", "-fPIC", "-o", lib, source], check=True)
    return ctypes.CDLL(lib)


def build_throughput():
    fn = build("libattention_limits.so", os.path.join(ROOT, "scripts", "attention_limits.cu"))
    fn = fn.attention_limits_throughput
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def step_clocks(fa, call):
    """Per consumer warpgroup, the mean clocks of one warp's pipeline step in
    each phase (PHASES), from one call of ``call`` through the kernel built
    with -DGTSFM_ATTN_CLOCKS; and that call's ms (CUDA events)."""
    import torch

    lib = build("libfused_attention_clocks.so", os.path.join(ROOT, "gtsfm_tpu_torch", "csrc", "fused_attention.cu"),
                "-DGTSFM_ATTN_CLOCKS")
    attn = lib.gtsfm_fused_attention
    attn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    attn.restype = ctypes.c_int
    read = lib.gtsfm_attention_clocks
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    kernel = fa._kernel
    fa._kernel = lambda: attn
    try:
        call()
        torch.cuda.synchronize()
        if read(None, 1) != 0:
            raise RuntimeError("could not reset the step clocks")
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        torch.cuda.synchronize()
    finally:
        fa._kernel = kernel
    out = (ctypes.c_ulonglong * 16)()
    if read(ctypes.addressof(out), 0) != 0:
        raise RuntimeError("could not read the step clocks")
    sums = np.array(out[:], dtype=np.float64).reshape(2, 8)
    return [sums[wg, :5] / sums[wg, 5] for wg in range(2)], a.elapsed_time(b)


def main() -> int:
    import torch

    import chip_smoke as cs
    from gtsfm_tpu_torch.frontend.matchers import fused_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("attention_limits: no CUDA device found")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    clock_hz = float(smi.split(",")[-1].split()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    run = build_throughput()
    blocks, threads, iters = sms, 1024, 2000
    out = torch.empty(blocks * threads, device="cuda")
    ticks = torch.empty(blocks, dtype=torch.int64, device="cuda")
    rate = {}
    for op, name in enumerate(OPS):
        for n in (10, iters):  # the first call warms up
            if run(op, out.data_ptr(), ticks.data_ptr(), blocks, threads, n) != 0:
                raise RuntimeError(f"throughput kernel {name} failed")
        rate[name] = threads * iters * 8 / float(ticks.float().mean())
        print(f"throughput {name}: {rate[name]:.2f} thread operations per clock per SM", flush=True)

    scores = P * HEADS * K * K
    exp_ms = scores / (rate["ex2.approx.ftz.f32"] * sms * clock_hz) * 1e3
    tensor_ms = 4.0 * scores * DH / cs.PEAK_BF16 * 1e3
    print(f"floors at P={P}, K={K}, {HEADS} heads of {DH}: the exponentials {exp_ms:.4f} ms at "
          f"{clock_hz / 1e9:.2f} GHz on {sms} SMs; the products {tensor_ms:.4f} ms at the bf16 peak "
          f"(chip_smoke.py's bound)", flush=True)

    rng = np.random.default_rng(0)

    def x(p, k):
        return torch.as_tensor(rng.normal(size=(p, k, HEADS * DH)).astype(np.float32),
                               device="cuda").to(torch.bfloat16)

    q0, q1, v1 = x(P, K), x(P, K), x(P, K)
    m1 = torch.as_tensor(rng.random((P, K)) >= 0.2, device="cuda")
    sd = [t.view(P, K, HEADS, DH).transpose(1, 2) for t in (q0, q1, v1)]
    add = torch.where(m1, 0.0, -1e9).to(torch.bfloat16)[:, None, None, :]
    calls = {
        "kernel": lambda: fa.fused_attention_merged(q0, q1, v1, HEADS, m1),
        "library": lambda: torch.nn.functional.scaled_dot_product_attention(*sd, attn_mask=add),
    }
    tiny = [x(1, 1) for _ in range(3)]
    tiny_mask = torch.ones((1, 1), dtype=torch.bool, device="cuda")
    fa.fused_attention_merged(*tiny, HEADS, tiny_mask)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        fa.fused_attention_merged(*tiny, HEADS, tiny_mask)
    host_ms = (time.perf_counter() - t0) / 200 * 1e3
    torch.cuda.synchronize()
    print(f"host time of one fused_attention_merged call (P=1, K=1): {host_ms:.4f} ms", flush=True)
    for which in ("kernel", "library", "library", "kernel"):
        one = cs._median_ms(calls[which], batch=1)
        many = cs._median_ms(calls[which])
        print(f"{which} at P={P}, K={K}: {one:.4f} ms one call at a time, {many:.4f} ms back to back "
              f"({cs.TIMING_BATCH} calls per sample; median of 20 samples, CUDA events)", flush=True)

    per_wg, clocks_ms = step_clocks(fa, calls["kernel"])
    bk = fa.key_tile(DH)
    # one step of both consumer warpgroups on one SM: 2 x 64 query rows
    # against bk keys
    tensor_clk = 2 * 4.0 * 64 * bk * DH / (cs.PEAK_BF16 / sms / clock_hz)
    exp_clk = 2 * 64 * bk / rate["ex2.approx.ftz.f32"]
    for wg, clk in enumerate(per_wg):
        print(f"step clocks, consumer warpgroup {wg} (mean over its warps' steps): "
              + ", ".join(f"{name} {c:.0f}" for name, c in zip(PHASES, clk)) + f"; step {clk.sum():.0f}", flush=True)
    print(f"one step of both consumers on an SM needs {tensor_clk:.0f} clocks of the tensor cores at the bf16 peak "
          f"and {exp_clk:.0f} of the exponential unit; the clocked build's call took {clocks_ms:.4f} ms "
          f"(the clock reads slow it)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
