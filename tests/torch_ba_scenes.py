"""Shared inputs of the port's bundle-adjustment parity tests
(tests/test_torch_ba*.py): seeded ring scenes of any calibration model,
built with numpy and the reference's SfmData constructor, one solve through
each package, and the comparison the tests make (final cost and poses to
1e-4 relative + 1e-4 absolute)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gtsfm_tpu.bundle.ba import BAOptions as JBAOptions, BundleAdjustment as JBA
from gtsfm_tpu.common.sfm_data import SfmData as JSfmData
from gtsfm_tpu.geometry import SE3 as JSE3, calibration as jcal
from gtsfm_tpu_torch.bundle.ba import BAOptions, BundleAdjustment
from gtsfm_tpu_torch.utils import convert

TOL = 1e-4

# per-camera intrinsics of each model (broadcast over the cameras)
CALS = {
    "Cal3Bundler": dict(f=500.0, k1=0.0, k2=0.0, u0=320.0, v0=240.0),
    "Cal3_S2": dict(fx=500.0, fy=505.0, s=0.5, u0=320.0, v0=240.0),
    "Cal3DS2": dict(fx=600.0, fy=606.0, s=0.0, u0=320.0, v0=240.0, k1=-0.05, k2=0.01, p1=5e-4, p2=-3e-4),
    "Cal3Fisheye": dict(fx=500.0, fy=500.0, s=0.0, u0=320.0, v0=240.0, k1=0.02, k2=-0.005, k3=1e-3, k4=-1e-4),
}


def ring_scene(model="Cal3Bundler", n_cams=8, n_tracks=60, noise=0.5, seed=0, pose_sigma=0.02, point_sigma=0.05,
               n_anchors=1, visible=0.75, pad_tracks=0, pad_meas=0) -> JSfmData:
    """A reference SfmData: n_cams on a 1.5 pi arc of radius 4 looking at
    the origin, n_tracks points in [-1, 1]^3, each seen by a random subset
    (at least 2) of the cameras with ``noise`` px Gaussian noise; poses
    (but the first n_anchors) perturbed by ``pose_sigma`` and points by
    ``point_sigma``; ``pad_*`` dead tracks and measurements appended."""
    rng = np.random.default_rng(seed)
    angles = np.linspace(0, 1.5 * np.pi, n_cams)
    centers = np.stack([4 * np.cos(angles), 4 * np.sin(angles), np.zeros(n_cams)], axis=1)
    Rs = []
    for c in centers:
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        Rs.append(np.stack([x, np.cross(z, x), z], axis=1))
    R = np.stack(Rs)
    X = rng.uniform(-1, 1, (n_tracks, 3))
    pc = np.einsum("nji,tnj->tni", R, X[:, None] - centers[None])  # (T, N, 3)
    cal = getattr(jcal, model).create(**{k: jnp.full(n_cams, v, jnp.float32) for k, v in CALS[model].items()})
    q = (pc[..., :2] / pc[..., 2:]).astype(np.float32)
    uv = np.asarray(cal.uncalibrate(jnp.asarray(q))) + rng.normal(0, noise, q.shape)
    seen = rng.random((n_tracks, n_cams)) < visible
    seen[:, :2] |= seen.sum(1, keepdims=True) < 2
    tracks = [(X[j] + rng.normal(0, point_sigma, 3), [(i, uv[j, i]) for i in np.flatnonzero(seen[j])])
              for j in range(n_tracks)]
    xi = rng.normal(0, pose_sigma, (n_cams, 6)).astype(np.float32)
    xi[:n_anchors] = 0
    poses = JSE3(R=jnp.asarray(R, jnp.float32), t=jnp.asarray(centers, jnp.float32)).retract(jnp.asarray(xi))
    m = int(seen.sum())
    return JSfmData.from_cameras_and_tracks(poses, cal, tracks, num_cameras=n_cams,
                                            pad_tracks_to=n_tracks + pad_tracks, pad_meas_to=m + pad_meas)


def gt_poses(n_cams=8):
    """The unperturbed ring poses of ring_scene (reference SE3)."""
    return ring_scene(n_cams=n_cams, n_tracks=2, pose_sigma=0.0, n_anchors=0).poses


def to_port(x):
    """A reference pytree (SfmData, SE3) -> the port's."""
    x = jax.tree.map(np.asarray, x)
    return convert.sfm_data(x) if isinstance(x, JSfmData) else convert.se3(x)


def with_uv(data: JSfmData, fn) -> JSfmData:
    uv = np.array(data.meas_uv)
    fn(uv)
    return data.replace(meas_uv=jnp.asarray(uv))


def solve_both(data_j: JSfmData, fixed=None, method="run", **kw):
    """One solve of the same scene and options through each package:
    -> ((out_j, metrics_j), (out_t, metrics_t)). ``kw`` holds the BAOptions
    fields plus prior arguments as numpy (rel_edges, rel_weight,
    prior_weight) or reference SE3 (rel_meas, prior_pose)."""
    prior_keys = ("rel_edges", "rel_meas", "rel_weight", "prior_pose", "prior_weight")
    priors = {k: kw.pop(k) for k in prior_keys if k in kw}
    pj = {k: (v if isinstance(v, JSE3) else jnp.asarray(v)) for k, v in priors.items()}
    pt = {k: (to_port(v) if isinstance(v, JSE3) else torch.as_tensor(np.asarray(v))) for k, v in priors.items()}
    fj = None if fixed is None else jnp.asarray(fixed)
    ft = None if fixed is None else torch.as_tensor(np.asarray(fixed))
    ref = getattr(JBA(JBAOptions(**kw)), method)(data_j, fixed_cam=fj, **pj)
    port = getattr(BundleAdjustment(BAOptions(**kw)), method)(to_port(data_j), fixed_cam=ft, **pt)
    return ref, port


def close(got, want, tol=TOL, what=""):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=tol, atol=tol, err_msg=what)


def assert_same_solve(ref, port, tol=TOL, cal=False):
    """Final cost, rotations, translations (and calibrations) of one solve
    agree to ``tol`` relative + ``tol`` absolute."""
    (out_j, m_j), (out_t, m_t) = ref, port
    close(m_t["final_cost"], m_j["final_cost"], tol, "final cost")
    close(m_t["initial_cost"], m_j["initial_cost"], tol, "initial cost")
    close(out_t.poses.R.numpy(), out_j.poses.R, tol, "rotations")
    close(out_t.poses.t.numpy(), out_j.poses.t, tol, "translations")
    close(out_t.points.numpy(), out_j.points, tol * 10, "points")
    if cal:
        close(out_t.cal.to_params().numpy(), out_j.cal.to_params(), tol, "calibrations")
    assert m_t["final_cost"] < m_t["initial_cost"]
