"""Port geometry and numerics against the JAX reference, at 1e-5.

Same seeded numpy inputs through gtsfm_tpu and gtsfm_tpu_torch: SO(3)
exp/log (including theta = pi - 1e-4), projection to SO(3), SE(3)
compose / inverse / exp / log, Cal3Bundler, camera projection with points
behind the camera, Sim3 robust alignment, and the unrolled tiny-system
solvers. Tolerance 1e-5: float32 round-off of O(1) quantities.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.geometry import SE3 as JSE3, Cal3Bundler as JCal, PinholeCamera as JCam, so3 as jso3
from gtsfm_tpu.geometry.sim3 import align_poses_sim3_robust as j_align
from gtsfm_tpu.utils import numerics as jnum
from gtsfm_tpu_torch.geometry import SE3, PinholeCamera, so3
from gtsfm_tpu_torch.geometry.sim3 import align_poses_sim3_robust
from gtsfm_tpu_torch.utils import convert, numerics
from tests.torch_threads import cap_threads

cap_threads()

TOL = 1e-5


def _axis_angles(rng, n):
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.concatenate([
        rng.uniform(0, np.pi, n - 4), [0.0, 1e-5, np.pi - 1e-4, np.pi - 1e-3]
    ])
    return (axes * angles[:, None]).astype(np.float32)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=tol, rtol=0)


def test_so3_exp_log_project_near_pi():
    rng = np.random.default_rng(0)
    w = _axis_angles(rng, 32)
    R_j = jso3.expmap(jnp.asarray(w))
    R_t = so3.expmap(torch.as_tensor(w))
    _close(R_t, R_j)
    # log of the same rotations, compared as rotations (sign-free at pi)
    Rs = np.asarray(R_j)
    _close(so3.expmap(so3.logmap(torch.as_tensor(Rs))), jso3.expmap(jso3.logmap(jnp.asarray(Rs))), 1e-4)
    _close(so3.logmap(torch.as_tensor(Rs))[:-2], jso3.logmap(jnp.asarray(Rs))[:-2], 1e-4)
    _close(so3.to_quat(torch.as_tensor(Rs)), jso3.to_quat(jnp.asarray(Rs)))
    M = (Rs + 0.05 * rng.normal(size=Rs.shape)).astype(np.float32)
    _close(so3.project(torch.as_tensor(M)), jso3.project(jnp.asarray(M)))
    mask = rng.random(32) > 0.3
    _close(
        so3.karcher_mean(torch.as_tensor(Rs[:8]), torch.as_tensor(mask[:8])),
        jso3.karcher_mean(jnp.asarray(Rs[:8]), jnp.asarray(mask[:8])),
        1e-4,
    )


def _poses(rng, n):
    R = np.asarray(jso3.expmap(jnp.asarray(_axis_angles(rng, n))))
    t = rng.normal(size=(n, 3)).astype(np.float32) * 3
    return R, t


def test_se3_compose_inverse_exp_log():
    rng = np.random.default_rng(1)
    R, t = _poses(rng, 16)
    R2, t2 = _poses(rng, 16)
    a_j, b_j = JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), JSE3(R=jnp.asarray(R2), t=jnp.asarray(t2))
    a_t, b_t = convert.se3({"R": R, "t": t}), convert.se3({"R": R2, "t": t2})
    c_j, c_t = a_j.compose(b_j.inverse()), a_t.compose(b_t.inverse())
    _close(c_t.R, c_j.R)
    _close(c_t.t, c_j.t, 5e-5)
    pts = rng.normal(size=(16, 3)).astype(np.float32)
    _close(a_t.transform_to(torch.as_tensor(pts)), a_j.transform_to(jnp.asarray(pts)), 5e-5)
    xi = np.concatenate([_axis_angles(rng, 16), rng.normal(size=(16, 3))], -1).astype(np.float32)
    e_j, e_t = JSE3.exp(jnp.asarray(xi)), SE3.exp(torch.as_tensor(xi))
    _close(e_t.R, e_j.R)
    _close(e_t.t, e_j.t, 5e-5)
    # log away from pi (at pi the axis sign is a free choice)
    _close(e_t.log()[:-2], e_j.log()[:-2], 1e-4)


def test_cal3bundler_and_camera_with_points_behind():
    rng = np.random.default_rng(2)
    n = 8
    f = rng.uniform(200, 600, n).astype(np.float32)
    k1 = rng.uniform(-0.1, 0.1, n).astype(np.float32)
    k2 = rng.uniform(-0.01, 0.01, n).astype(np.float32)
    u0 = np.full(n, 160.0, np.float32)
    v0 = np.full(n, 120.0, np.float32)
    cal_j = JCal.create(f, k1, k2, u0, v0)
    cal_t = convert.cal3_bundler({"f": f, "k1": k1, "k2": k2, "u0": u0, "v0": v0})
    p = rng.uniform(-0.5, 0.5, (n, 2)).astype(np.float32)
    uv_j = cal_j.uncalibrate(jnp.asarray(p))
    uv_t = cal_t.uncalibrate(torch.as_tensor(p))
    _close(uv_t, uv_j, 1e-3)  # pixels: 1e-5 relative at f ~ 600
    _close(cal_t.calibrate(uv_t), cal_j.calibrate(uv_j))

    R, t = _poses(rng, n)
    pts = rng.normal(size=(n, 3)).astype(np.float32) * 4  # about half behind
    cam_j = JCam(pose=JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), cal=cal_j)
    cam_t = PinholeCamera(pose=convert.se3({"R": R, "t": t}), cal=cal_t)
    uv_j, z_j = cam_j.project(jnp.asarray(pts))
    uv_t, z_t = cam_t.project(torch.as_tensor(pts))
    assert (np.asarray(z_j) < 0).any()
    _close(z_t, z_j, 5e-5)
    np.testing.assert_allclose(np.asarray(uv_t), np.asarray(uv_j), rtol=1e-5, atol=1e-3)


def test_sim3_robust_alignment():
    rng = np.random.default_rng(3)
    R, t = _poses(rng, 12)
    s_R = np.asarray(jso3.expmap(jnp.asarray([0.3, -0.2, 0.5], jnp.float32)))
    R2 = np.einsum("ij,njk->nik", s_R, R).astype(np.float32)
    t2 = (1.7 * t @ s_R.T + np.array([1.0, -2.0, 0.5]) + 0.01 * rng.normal(size=t.shape)).astype(np.float32)
    t2[3] += 5.0  # one outlier center
    mask = np.ones(12, bool)
    mask[7] = False
    sim_j = j_align(JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), JSE3(R=jnp.asarray(R2), t=jnp.asarray(t2)),
                    mask=jnp.asarray(mask))
    sim_t = align_poses_sim3_robust(convert.se3({"R": R, "t": t}), convert.se3({"R": R2, "t": t2}),
                                    mask=torch.as_tensor(mask))
    _close(sim_t.R, sim_j.R, 1e-4)
    _close(sim_t.s, sim_j.s, 1e-4)
    _close(sim_t.t, sim_j.t, 1e-3)


@pytest.mark.parametrize("n", [4, 9])
def test_tiny_system_solvers(n):
    rng = np.random.default_rng(10 + n)
    A = rng.normal(size=(64, n + 2, n)).astype(np.float32)
    AtA = np.einsum("bki,bkj->bij", A, A).astype(np.float32)
    b = rng.normal(size=(64, n)).astype(np.float32)
    _close(numerics.nullvec_pinned(torch.as_tensor(AtA)), jnum.nullvec_pinned(jnp.asarray(AtA)), 1e-4)
    _close(numerics.nullvec_pinned_scalarized(torch.as_tensor(AtA)),
           jnum.nullvec_pinned_scalarized(jnp.asarray(AtA)), 1e-4)
    x_t = numerics.solve_psd_unrolled(torch.as_tensor(AtA), torch.as_tensor(b))
    x_j = jnum.solve_psd_unrolled(jnp.asarray(AtA), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(x_t), np.asarray(x_j), rtol=1e-3, atol=1e-4)
    assert numerics.ceil_pow2(n, 16) == jnum.ceil_pow2(n, 16)


def test_precise_turns_tf32_off_and_restores():
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        with numerics.precise():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def test_counter_uniform_is_keyed_by_stream_not_batch():
    ids = torch.arange(10, 20)
    u = numerics.counter_uniform(0, 2, ids, (4, 1000), 0.5, 1.0)
    assert u.shape == (10, 4, 1000) and u.dtype == torch.float32
    assert float(u.min()) >= 0.5 and float(u.max()) < 1.0
    assert abs(float(u.mean()) - 0.75) < 0.01
    # one stream drawn alone equals the same stream inside a batch
    assert torch.equal(numerics.counter_uniform(0, 2, ids[3:4], (4, 1000), 0.5, 1.0)[0], u[3])
    assert not torch.equal(u[0], u[1])
    assert not torch.equal(numerics.counter_uniform(1, 2, ids, (4, 1000)), numerics.counter_uniform(0, 2, ids, (4, 1000)))


def test_block_and_segment_sums_match_reference_scatter_add():
    """The port's fixed-order assembly (``SegmentSum``) against the
    reference's ``.at[].add`` scatter on the same repeated indices, with
    some output rows and blocks that no index reaches."""
    rng = np.random.default_rng(7)
    n, E = 9, 200
    rows = rng.integers(0, n - 1, E)  # row n - 1 stays empty
    cols = rng.integers(0, n, E)
    blocks = rng.normal(size=(E, 3, 3)).astype(np.float32)
    block_sum = numerics.SegmentSum((n, n), torch.as_tensor(rows), torch.as_tensor(cols))
    want = jnp.zeros((n, n, 3, 3)).at[rows, cols].add(jnp.asarray(blocks))
    _close(block_sum(torch.as_tensor(blocks)), want)
    scalars = blocks[:, 0, 0]
    want = jnp.zeros((n, n)).at[rows, cols].add(jnp.asarray(scalars))
    _close(block_sum(torch.as_tensor(scalars)), want)
    want = jnp.zeros((n, 3, 3)).at[rows].add(jnp.asarray(blocks))
    _close(numerics.SegmentSum((n,), torch.as_tensor(rows))(torch.as_tensor(blocks)), want)
    empty = numerics.SegmentSum((n,), torch.zeros(0, dtype=torch.int64))
    assert torch.equal(empty(torch.zeros((0, 3))), torch.zeros((n, 3)))


def _nan_case(name, rng):
    """(port output, JAX output) of one solver site on an input holding a
    NaN: so3.project, align_points_umeyama, triangulate_dlt and
    classify_tracks_by_gt."""
    from gtsfm_tpu.bundle.triangulation import triangulate_dlt as j_dlt
    from gtsfm_tpu.geometry.sim3 import align_points_umeyama as j_umeyama
    from gtsfm_tpu.utils.tracks import classify_tracks_by_gt as j_classify
    from gtsfm_tpu_torch.bundle.triangulation import triangulate_dlt
    from gtsfm_tpu_torch.geometry.sim3 import align_points_umeyama
    from gtsfm_tpu_torch.utils.tracks import classify_tracks_by_gt

    if name == "so3.project":
        M = rng.normal(size=(3, 3, 3)).astype(np.float32)
        M[1, 0, 2] = np.nan
        return so3.project(torch.as_tensor(M)), jso3.project(jnp.asarray(M))
    if name == "sim3.align_points_umeyama":
        src = rng.normal(size=(10, 3)).astype(np.float32)
        dst = (src * 1.5 + 0.2).astype(np.float32)
        src[4, 1] = np.nan
        sim_t = align_points_umeyama(torch.as_tensor(src), torch.as_tensor(dst))
        sim_j = j_umeyama(jnp.asarray(src), jnp.asarray(dst))
        return sim_t.R, sim_j.R
    R = np.asarray(jso3.expmap(jnp.asarray(rng.normal(size=(3, 3)).astype(np.float32) * 0.2)))
    t = rng.normal(size=(3, 3)).astype(np.float32)
    xy = rng.uniform(-0.3, 0.3, (3, 2)).astype(np.float32)
    xy[1, 0] = np.nan
    if name == "triangulation.triangulate_dlt":
        mask = np.ones(3, bool)
        return (triangulate_dlt(convert.se3({"R": R, "t": t}), torch.as_tensor(xy), torch.as_tensor(mask)),
                j_dlt(JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), jnp.asarray(xy), jnp.asarray(mask)))
    f = np.full(3, 300.0, np.float32)
    z = np.zeros(3, np.float32)
    c = np.full(3, 160.0, np.float32)
    cam, uv, mask = np.arange(3)[None], (xy * 300.0 + 160.0)[None], np.ones((1, 3), bool)
    _, err_t = classify_tracks_by_gt(convert.se3({"R": R, "t": t}),
                                     convert.cal3_bundler({"f": f, "k1": z, "k2": z, "u0": c, "v0": c}),
                                     cam, uv, mask)
    _, err_j = j_classify(JSE3(R=jnp.asarray(R), t=jnp.asarray(t)), JCal.create(f, z, z, c, c), cam, uv, mask)
    return torch.as_tensor(err_t), err_j


@pytest.mark.parametrize("name", ["so3.project", "sim3.align_points_umeyama", "triangulation.triangulate_dlt",
                                  "tracks.classify_tracks_by_gt"])
def test_solver_sites_give_nan_on_nan_input_as_jax(name):
    """Each site's SVD or eigh meets a NaN: torch's own raises there, JAX
    returns NaN; the port must return NaN wherever JAX does, and raise
    nothing."""
    got, want = _nan_case(name, np.random.default_rng(20))
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert np.isnan(want).any(), name
    assert got.shape == want.shape
    assert np.isnan(got[np.isnan(want)]).all(), name
