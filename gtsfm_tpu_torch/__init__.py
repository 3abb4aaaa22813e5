"""gtsfm_tpu_torch — the PyTorch / CUDA port of gtsfm_tpu.

Each module mirrors one file of the JAX package (``gtsfm_tpu``), which stays
the reference: the same function names, the same padded layouts and masks,
the same defaults. The entry points (``SceneOptimizer``,
``GaussianSplatting``, the feed-forward, VGGT and PatchmatchNet models) run
on the CUDA card unless given ``device="cpu"``.
Every Pallas kernel of the reference is a hand-written CUDA kernel under
``csrc/`` that runs on a CUDA tensor; on a CPU tensor its plain PyTorch
version runs.

The port keeps its own copies of what it needs from the reference, host
numpy modules and C++ host libraries included (DSF track linking, cycle
consistency, graph utilities, ``native/``). Importing this package never
imports ``jax``, ``flax``, ``triton`` or ``gtsfm_tpu``.
"""

__version__ = "0.1.0"
