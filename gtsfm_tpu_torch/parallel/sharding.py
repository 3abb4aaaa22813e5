"""Sharding over a (data, model) mesh of ``torch.distributed`` ranks.

Port of gtsfm_tpu/parallel/sharding.py. The reference builds a
``jax.sharding.Mesh`` and lets XLA insert the collectives; the port runs one
process per mesh position and writes each collective out:

- the pair axis of a two-view chunk is split over ``data``
  (``shard_pair_batch``), each chunk's results gathered back in pair order;
- desc1's keypoint rows of the mutual-NN matcher are split over ``model``
  in whole 128-row tiles (``model_row_range``), the kernel's row and column
  outputs gathered in rank order before its finish;
- BA's measurement axis is split over ``data`` (``shard_ba_problem``),
  cameras and points replicated, and each measurement-side sum
  ``all_reduce``d over ``data`` (``ReducedSum``).

Rank r sits at (r // model, r % model): a rank's ``data`` group is the ranks
of its column, its ``model`` group those of its row. Every collective is an
``all_reduce`` (sum) on one of these groups, because Gloo moves CUDA tensors
in ``all_reduce`` and ``broadcast`` only. A gather is an ``all_reduce`` of a
zero-filled buffer into which each rank wrote its own slice, summed as
integers of the same width, so every bit (-0.0 and NaN included) arrives as
it was sent. Sums of floats are ``all_reduce``d as floats: the order is
fixed for a fixed world, so repeat runs are bit-identical, and every rank
receives the same bits.

The module imports ``torch`` alone.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

AXES = ("data", "model")


def mesh_shape(n: int, data_model_split: bool = True) -> tuple:
    """The reference's rule: (n // 2, 2) when n >= 4 is even and the split
    is asked for, else (n, 1)."""
    if data_model_split and n >= 4 and n % 2 == 0:
        return (n // 2, 2)
    return (n, 1)


def backend_for(device_type: str, ranks_per_host: int, cards_per_host: int) -> str:
    """The process group's backend for this topology: NCCL when each rank of
    a host has a card of its own (rank i on ``cuda:i``), Gloo when ranks
    share a card (NCCL refuses two ranks on one device) and for a run on
    the CPU."""
    if device_type == "cuda" and 0 < ranks_per_host <= cards_per_host:
        return "nccl"
    return "gloo"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place on a (data, model) mesh. ``shape`` maps each axis
    to its size, ``coord`` to this rank's index along it, ``groups`` to the
    process group of the ranks that share this rank's other coordinate."""

    shape: dict
    coord: dict
    groups: dict


def make_mesh(n_devices: int | None = None, data_model_split: bool = True) -> Mesh:
    """A ("data", "model") mesh over the ranks of the default process group,
    of shape ``mesh_shape(world)``. Every rank must call it, in the same
    order relative to its other collectives: it creates the axes' groups.
    ``n_devices``, when given, must be the world size (one rank a mesh
    position)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized torch.distributed process group")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices not in (None, world):
        raise ValueError(f"a mesh of {n_devices} positions over {world} ranks")
    D, M = mesh_shape(world, data_model_split)
    lines = {"data": [[d * M + m for d in range(D)] for m in range(M)],
             "model": [[d * M + m for m in range(M)] for d in range(D)]}
    groups = {}
    for axis in AXES:
        for ranks in lines[axis]:
            group = dist.new_group(ranks)  # every rank creates every group, in one order
            if rank in ranks:
                groups[axis] = group
    return Mesh(shape={"data": D, "model": M}, coord={"data": rank // M, "model": rank % M}, groups=groups)


def _bits(t: torch.Tensor) -> torch.Tensor:
    """An integer view of ``t`` of its element width (bool as uint8)."""
    if t.dtype == torch.bool:
        return t.view(torch.uint8)
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])
    return t


def gather(mesh: Mesh, axis: str, part: torch.Tensor, lo: int, total: int, dim: int = 0) -> torch.Tensor:
    """The tensor of length ``total`` along ``dim`` whose slice [lo, lo +
    len) each rank of this rank's ``axis`` group holds as ``part``: exact,
    every rank gets the same bits. The slices must tile [0, total)."""
    shape = list(part.shape)
    shape[dim] = total
    buf = part.new_zeros(shape)
    buf.narrow(dim, lo, part.shape[dim]).copy_(part)
    dist.all_reduce(_bits(buf), group=mesh.groups[axis])
    return buf


def all_reduce_sum(mesh: Mesh, axis: str, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over this rank's ``axis`` group (in place; returned)."""
    dist.all_reduce(t, group=mesh.groups[axis])
    return t


class ReducedSum:
    """A measurements -> cameras or tracks sum (``numerics.SegmentSum``) on
    this rank's measurement shard, ``all_reduce``d over ``data``: the whole
    problem's sum on every rank."""

    def __init__(self, local_sum, mesh: Mesh):
        self.local_sum = local_sum
        self.mesh = mesh

    def __call__(self, vals: torch.Tensor) -> torch.Tensor:
        return all_reduce_sum(self.mesh, "data", self.local_sum(vals))


def shard_range(n: int, parts: int, index: int, unit: int = 1) -> tuple:
    """[lo, hi) of part ``index`` when n items are cut into ``parts`` runs
    of whole ``unit``s, as even as whole units allow (the first parts take
    the extra units; a part may be empty)."""
    units = -(-n // unit)
    base, extra = divmod(units, parts)
    lo = unit * (index * base + min(index, extra))
    hi = unit * ((index + 1) * base + min(index + 1, extra))
    return min(lo, n), min(hi, n)


def model_row_range(mesh: Mesh, K1: int, tile: int) -> tuple:
    """This rank's [lo, hi) of desc1's K1 rows on the ``model`` axis: whole
    ``tile``-row tiles, so that its column buffer's row tiles are the
    unsplit buffer's."""
    return shard_range(K1, mesh.shape["model"], mesh.coord["model"], tile)


def shard_pair_batch(mesh: Mesh, batch: dict) -> dict:
    """This rank's share of a two-view chunk: every per-pair entry (a tensor
    or a calibration batch with ``map``, leading axis P) cut to the rank's
    P / data consecutive pairs on ``data``; ``P`` must divide by ``data``.
    The keypoint rows of desc1 are split over ``model`` inside the matcher
    (``model_row_range``), after the data split."""
    P = batch["pair_mask"].shape[0]
    D = mesh.shape["data"]
    if P % D:
        raise ValueError(f"{P} pairs do not divide over a data axis of {D}")
    lo = mesh.coord["data"] * (P // D)
    hi = lo + P // D
    return {k: (v.map(lambda a: a[lo:hi]) if hasattr(v, "map") else v[lo:hi]) for k, v in batch.items()}


def shard_ba_problem(mesh: Mesh, prob):
    """This rank's BA problem: the measurements padded to a multiple of
    ``data`` by rows of weight 0 on camera 0 and track 0 (the reference's
    padding, ba.py:1299-1308) and cut to the rank's consecutive M / data;
    cameras, calibrations, points, priors and ``fixed_cam`` whole."""
    D = mesh.shape["data"]
    pad = -prob.meas_cam.shape[0] % D
    m = (prob.meas_cam.shape[0] + pad) // D
    lo = mesh.coord["data"] * m

    def shard(a):
        return torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])[lo : lo + m]

    return prob.replace(meas_cam=shard(prob.meas_cam), meas_track=shard(prob.meas_track),
                        meas_uv=shard(prob.meas_uv), meas_w=shard(prob.meas_w))
