"""Image-pair retrieval: sequential, exhaustive, similarity, joint.

Port of gtsfm_tpu/retriever/retrievers.py. The pair lists are host numpy,
as in the reference. The similarity matrix is one (N, D) x (D, N) product
of bf16-rounded operands summed in float32, on the device of the
descriptors; it is kept for diagnostics (``latest_similarity_matrix``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from gtsfm_tpu_torch.utils.numerics import precise


class RetrieverOptions(NamedTuple):
    num_matched: int = 5  # top-K per query
    min_score: float = 0.3
    max_frame_lookahead: int = 15  # sequential window


def filter_loader_valid(pairs: np.ndarray, loader) -> np.ndarray:
    """Drop pairs the loader declares invalid (``LoaderBase.is_valid_pair``).
    No-op when loader is None."""
    if loader is None or len(pairs) == 0:
        return pairs
    keep = [bool(loader.is_valid_pair(int(i), int(j))) for i, j in pairs]
    return pairs[np.asarray(keep, bool)].reshape(-1, 2)


def sequential_pairs(num_images: int, max_frame_lookahead: int) -> np.ndarray:
    """Sliding-window pairs (i, j), 0 < j - i <= lookahead, sorted."""
    i, j = np.triu_indices(num_images, k=1)
    keep = j - i <= max_frame_lookahead
    return np.stack([i[keep], j[keep]], axis=1).astype(np.int32).reshape(-1, 2)


def exhaustive_pairs(num_images: int) -> np.ndarray:
    i, j = np.triu_indices(num_images, k=1)
    return np.stack([i, j], axis=1).astype(np.int32).reshape(-1, 2)


def similarity_matrix(descriptors: torch.Tensor, use_bf16: bool = True) -> torch.Tensor:
    """Cosine similarity (N, N) from global descriptors (N, D)."""
    d = descriptors / torch.clamp(torch.linalg.vector_norm(descriptors, dim=-1, keepdim=True), min=1e-12)
    if use_bf16:
        # bf16 operands, exact products summed in float32
        d = d.to(torch.bfloat16).to(torch.float32)
    with precise():
        return torch.matmul(d, d.T)


def pairs_from_similarity_matrix(sim, num_matched: int = 5, min_score: float = 0.3) -> np.ndarray:
    """Top-K above-threshold pairs per query row of a similarity matrix
    (also the entry point for matrices produced elsewhere)."""
    sim = torch.as_tensor(sim)
    n = sim.shape[0]
    sim = sim - 2.0 * torch.eye(n, dtype=sim.dtype, device=sim.device)  # exclude self
    scores, idx = torch.topk(sim, min(num_matched, n - 1) if n > 1 else 1, dim=1)
    scores = scores.cpu().numpy()
    idx = idx.cpu().numpy()
    rows = np.repeat(np.arange(n), idx.shape[1])
    cols = idx.reshape(-1)
    keep = (scores.reshape(-1) >= min_score) & (rows != cols)
    a, b = rows[keep], cols[keep]
    pairs = np.unique(np.stack([np.minimum(a, b), np.maximum(a, b)], axis=1).reshape(-1, 2), axis=0)
    return pairs.astype(np.int32).reshape(-1, 2)


def similarity_pairs(descriptors: torch.Tensor, num_matched: int = 5, min_score: float = 0.3) -> tuple:
    """Top-K above-threshold pairs per query. Returns (pairs (P, 2) numpy,
    the similarity matrix with the diagonal lowered by 2, numpy)."""
    sim = similarity_matrix(descriptors)
    sim = sim - 2.0 * torch.eye(sim.shape[0], dtype=sim.dtype, device=sim.device)  # exclude self
    return pairs_from_similarity_matrix(sim, num_matched, min_score), sim.cpu().numpy()


class SequentialRetriever:
    def __init__(self, options: RetrieverOptions = RetrieverOptions()):
        self.options = options

    def get_image_pairs(self, num_images: int, global_descriptors=None, loader=None) -> np.ndarray:
        return filter_loader_valid(sequential_pairs(num_images, self.options.max_frame_lookahead), loader)


class ExhaustiveRetriever:
    def get_image_pairs(self, num_images: int, global_descriptors=None, loader=None) -> np.ndarray:
        return filter_loader_valid(exhaustive_pairs(num_images), loader)


class SimilarityRetriever:
    def __init__(self, options: RetrieverOptions = RetrieverOptions()):
        self.options = options
        self.latest_similarity_matrix: Optional[np.ndarray] = None

    def get_image_pairs(self, num_images: int, global_descriptors=None, loader=None) -> np.ndarray:
        if global_descriptors is None:
            raise ValueError("SimilarityRetriever requires global descriptors")
        pairs, sim = similarity_pairs(torch.as_tensor(global_descriptors), self.options.num_matched,
                                      self.options.min_score)
        self.latest_similarity_matrix = sim
        return filter_loader_valid(pairs, loader)


class JointSimilaritySequentialRetriever:
    """Union of similarity and sequential pairs."""

    def __init__(self, options: RetrieverOptions = RetrieverOptions()):
        self.options = options
        self.similarity = SimilarityRetriever(options)
        self.latest_similarity_matrix: Optional[np.ndarray] = None

    def get_image_pairs(self, num_images: int, global_descriptors=None, loader=None) -> np.ndarray:
        seq = sequential_pairs(num_images, self.options.max_frame_lookahead)
        if global_descriptors is None:
            return filter_loader_valid(seq, loader)
        sim = self.similarity.get_image_pairs(num_images, global_descriptors)
        self.latest_similarity_matrix = self.similarity.latest_similarity_matrix
        pairs = np.unique(np.concatenate([seq, sim]).reshape(-1, 2), axis=0).astype(np.int32)
        return filter_loader_valid(pairs, loader)
