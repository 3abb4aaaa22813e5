"""Work of one call of the mutual-NN matcher on a chunk of pairs: the
similarity of the valid keypoints, 2 * D * n1 * n2 operations a pair (the
products the answer needs, on bf16 tensor cores), and the bytes of the
descriptors and masks read once and the three per-row outputs (index,
mask, best similarity) written once. The arithmetic of the port's kernel
table (PERF.md, kernel #1), over the valid keypoints."""

from __future__ import annotations


def mutual_nn_work(desc1, desc2, mask1, mask2) -> tuple:
    """(operations as a device tensor, bytes)."""
    n1, n2 = mask1.sum(-1).double(), mask2.sum(-1).double()
    flops = 2.0 * desc1.shape[-1] * (n1 * n2).sum()
    nbytes = desc1.nbytes + desc2.nbytes + mask1.nbytes + mask2.nbytes + desc1.shape[0] * desc1.shape[1] * (4 + 1 + 4)
    return flops, nbytes
