"""Operations of VGGT (perfbench/reference/vggt.py), 2 per multiply-add of
every matrix product and convolution (no norms, activations, softmax,
resizes or sampling), from the shapes:

- a transformer block of T tokens in sequences of n at width D with MLP
  ratio 4: qkv, proj and the MLP 24 T D^2, attention 4 T n D (q k^T and
  p v, 2 T n D each);
- the aggregator on S frames of gh x gw patches (L = 1 + registers +
  gh gw tokens): the DINO patch convolution and its blocks (sequences of
  L), then ``depth`` frame blocks (sequences of L) and ``depth`` global
  blocks (one sequence of S L);
- the camera head: its trunk over the S camera tokens at width 2D,
  modulation, pose embedding and branch, per iteration;
- a DPT head: projections, the resize pyramid, the four 3x3 reductions,
  the refinement units and output convolutions at their own sizes;
- the track head: its DPT features, and per iteration the correlation
  maps of every level, the correlation MLP and the update former (time
  attention over S frames of N + V tracks, space attention between the N
  points and V virtual tracks of each frame), the heads on the tracks.

``attention_work`` is the work of one attention call, the frame and global
blocks' share: 4 n D per query token for the operations, and q, k, v read
once and the output written once, in float32, for the bytes."""

from __future__ import annotations


def attention_work(tokens: int, seq_len: int, width: int, itemsize: int = 4) -> tuple:
    """(operations, bytes) of attention over ``tokens`` query tokens in
    sequences of ``seq_len`` at total head width ``width``."""
    return 4.0 * tokens * seq_len * width, 4.0 * tokens * width * itemsize


def _block(T: int, n: int, D: int, mlp_ratio: int = 4) -> float:
    return 2.0 * T * D * (4 * D + 2 * mlp_ratio * D) + 4.0 * T * n * D


def _conv(h: int, w: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * h * w * cin * cout * k * k


def _half(n: int) -> int:  # a 3x3 convolution of stride 2 and padding 1
    return (n - 1) // 2 + 1


def dpt_flops(m: dict, gh: int, gw: int, features: int, conv1_out: int, down: int, output_dim) -> float:
    """One frame through a DPT head of ``features`` channels."""
    oc, C2, F, p = m["dpt_out_channels"], 2 * m["embed_dim"], features, m["patch_size"]
    P = gh * gw
    sizes = [(4 * gh, 4 * gw), (2 * gh, 2 * gw), (gh, gw), (_half(gh), _half(gw))]
    f = sum(2.0 * P * C2 * c for c in oc)  # projections
    f += 2.0 * P * oc[0] * oc[0] * 16 + 2.0 * P * oc[1] * oc[1] * 4 + _conv(*sizes[3], oc[3], oc[3], 3)
    f += sum(_conv(h, w, c, F, 3) for (h, w), c in zip(sizes, oc))  # layer*_rn
    rcu = lambda h, w: 2 * _conv(h, w, F, F, 3)  # noqa: E731
    f += rcu(*sizes[3]) + _conv(*sizes[2], F, F, 1)  # refinenet4, out_conv at layer 3's size
    f += 2 * rcu(*sizes[2]) + _conv(*sizes[1], F, F, 1)
    f += 2 * rcu(*sizes[1]) + _conv(*sizes[0], F, F, 1)
    f += 2 * rcu(*sizes[0]) + _conv(8 * gh, 8 * gw, F, F, 1)
    f += _conv(8 * gh, 8 * gw, F, conv1_out, 3)
    if output_dim is not None:
        h, w = gh * p // down, gw * p // down
        f += _conv(h, w, conv1_out, 32, 3) + _conv(h, w, 32, output_dim, 1)
    return f


def aggregator_flops(m: dict, S: int, H: int, W: int) -> float:
    """One aggregator pass over S frames of H x W."""
    D, p, r = m["embed_dim"], m["patch_size"], m["num_register_tokens"]
    gh, gw = H // p, W // p
    L = 1 + r + gh * gw
    dino = S * (2.0 * gh * gw * 3 * p * p * D + m["dino_depth"] * _block(L, L, D, m["mlp_ratio"]))
    frame = _block(S * L, L, D, m["mlp_ratio"])
    glob = _block(S * L, S * L, D, m["mlp_ratio"])
    return dino + m["depth"] * (frame + glob)


def camera_flops(m: dict, S: int) -> float:
    C2, k = 2 * m["embed_dim"], m["pose_dim"]
    per_iter = 2.0 * S * k * C2 + 2.0 * S * C2 * 3 * C2 + m["camera_trunk_depth"] * _block(S, S, C2, m["mlp_ratio"])
    per_iter += 2.0 * S * C2 * (C2 // 2) + 2.0 * S * (C2 // 2) * k
    return m["camera_iterations"] * per_iter


def tracker_flops(m: dict, S: int, H: int, W: int, N: int) -> float:
    """The tracker on N queries over features at (H, W) / stride."""
    t = m["track"]
    C, E, V, st = t["latent_dim"], t["hidden_size"], t["num_virtual_tracks"], t["stride"]
    gh, gw = H // m["patch_size"], W // m["patch_size"]
    h, w = gh * m["patch_size"] // st, gw * m["patch_size"] // st
    corr = 0.0
    for _ in range(t["corr_levels"]):
        corr += 2.0 * S * N * C * h * w
        h, w = h // 2, w // 2
    kc = t["corr_levels"] * (2 * t["corr_radius"] + 1) ** 2
    per_iter = corr + 2.0 * S * N * (kc * E + E * C) + 2.0 * N * S * (3 * C + 4) * E
    for _ in range(t["depth"]):
        per_iter += _block((N + V) * S, S, E)  # time
        per_iter += 2.0 * S * V * E * E * 2 + 2.0 * S * N * E * E * 2 + 4.0 * S * V * N * E + 16.0 * S * V * E * E
        per_iter += _block(S * V, V, E)  # virtual self-attention
        per_iter += 2.0 * S * N * E * E * 2 + 2.0 * S * V * E * E * 2 + 4.0 * S * N * V * E + 16.0 * S * N * E * E
    per_iter += 2.0 * N * S * E * (C + 2) + 2.0 * N * S * C * C
    return t["iters"] * per_iter + 2 * 2.0 * S * N * C


def pass_flops(m: dict, S: int, H: int, W: int, N: int) -> float:
    """A pass of the vggt slot: the products (an aggregator pass, the camera
    and depth heads) and the tracks of N queries (a second aggregator pass,
    the track head)."""
    gh, gw = H // m["patch_size"], W // m["patch_size"]
    t = m["track"]
    products = aggregator_flops(m, S, H, W) + camera_flops(m, S) + S * dpt_flops(
        m, gh, gw, m["dpt_features"], m["dpt_features"] // 2, 1, 2)
    tracks = aggregator_flops(m, S, H, W) + S * dpt_flops(m, gh, gw, t["dpt_features"], t["latent_dim"], t["stride"],
                                                          None) + tracker_flops(m, S, H, W, N)
    return products + tracks
