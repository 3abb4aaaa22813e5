"""gtsfm_tpu_torch — the PyTorch / CUDA port of gtsfm_tpu.

Each module mirrors one file of the JAX package (``gtsfm_tpu``), which stays
the reference: the same function names, the same padded layouts and masks,
the same defaults. The port runs on whatever device its input tensors live
on. On an NVIDIA Hopper card the one Pallas kernel on the reconstruction
path, the fused mutual-NN matcher, is a hand-written CUDA kernel
(``csrc/fused_matcher.cu``); on the CPU its plain PyTorch version runs.

Host-only numpy modules of the reference (DSF track linking, cycle
consistency, graph utilities and the g++ build of the native libraries)
import no JAX and are reused from ``gtsfm_tpu`` as they are. Importing this
package never imports ``jax``, ``flax`` or ``triton``.
"""

__version__ = "0.1.0"
