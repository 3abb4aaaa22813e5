"""The port's calibration models against the JAX reference.

Seeded numpy intrinsics and points feed both packages for Cal3Bundler,
Cal3_S2, Cal3DS2 and Cal3Fisheye: ``uncalibrate``, ``calibrate``, ``K`` and
the ``to_params`` / ``with_params`` round trip agree to 1e-5 (relative to
the largest value compared; float32 order only). The fisheye at the
principal point (r = 0) keeps finite values and a finite forward-mode
Jacobian, in both directions. ``convert.calibration`` carries each
reference model across by its type.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.geometry import calibration as jcal
from gtsfm_tpu_torch.geometry import calibration as tcal
from gtsfm_tpu_torch.utils import convert
from gtsfm_tpu_torch.utils.numerics import jacobian_fwd
from tests.torch_threads import cap_threads

cap_threads()

N = 6
MODELS = ("Cal3Bundler", "Cal3_S2", "Cal3DS2", "Cal3Fisheye")


def _params(name: str, rng) -> dict:
    """Per-camera constructor arguments (N,) of a realistic camera."""
    f = rng.uniform(400, 700, N)
    u0, v0 = rng.uniform(300, 340, N), rng.uniform(220, 260, N)
    if name == "Cal3Bundler":
        return dict(f=f, k1=rng.uniform(-0.1, 0.1, N), k2=rng.uniform(-0.02, 0.02, N), u0=u0, v0=v0)
    kw = dict(fx=f, fy=f * rng.uniform(0.98, 1.02, N), s=rng.uniform(-1, 1, N), u0=u0, v0=v0)
    if name == "Cal3DS2":
        kw.update(k1=rng.uniform(-0.1, 0.1, N), k2=rng.uniform(-0.02, 0.02, N), p1=rng.uniform(-1e-3, 1e-3, N),
                  p2=rng.uniform(-1e-3, 1e-3, N))
    if name == "Cal3Fisheye":
        kw.update(k1=rng.uniform(-0.05, 0.05, N), k2=rng.uniform(-0.01, 0.01, N), k3=rng.uniform(-1e-3, 1e-3, N),
                  k4=rng.uniform(-1e-4, 1e-4, N))
    return {k: v.astype(np.float32) for k, v in kw.items()}


def _pair(name: str, seed: int):
    kw = _params(name, np.random.default_rng(seed))
    return (getattr(jcal, name).create(**{k: jnp.asarray(v) for k, v in kw.items()}),
            getattr(tcal, name).create(**kw))


def _close(got, want, tol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol, atol=tol * max(np.abs(want).max(), 1.0))


@pytest.mark.parametrize("name", MODELS)
def test_calibration_matches_reference(name):
    cj, ct = _pair(name, MODELS.index(name))
    rng = np.random.default_rng(10 + MODELS.index(name))
    p = rng.uniform(-0.5, 0.5, (N, 40, 2)).astype(np.float32)
    bj = jax.tree.map(lambda a: a[:, None], cj)
    bt = ct.map(lambda a: a[:, None])
    uv_j = np.array(bj.uncalibrate(jnp.asarray(p)))
    uv_t = bt.uncalibrate(torch.as_tensor(p))
    _close(uv_t.numpy(), uv_j)
    _close(bt.calibrate(torch.as_tensor(uv_j)).numpy(), np.asarray(bj.calibrate(jnp.asarray(uv_j))))
    _close(bt.calibrate(uv_t).numpy(), p, tol=1e-4)  # the inversion itself, to its fixed step count
    _close(ct.K().numpy(), np.asarray(cj.K()))
    _close(ct.fx.numpy(), np.asarray(cj.fx))
    _close(ct.fy.numpy(), np.asarray(cj.fy))
    params = ct.to_params()
    np.testing.assert_array_equal(params.numpy(), np.asarray(cj.to_params()))
    assert params.shape == (N, ct.dof) and ct.dof == getattr(jcal, name).dof
    moved = params * 1.01
    back = ct.with_params(moved)
    assert type(back) is type(ct)
    np.testing.assert_array_equal(back.to_params().numpy(), moved.numpy())
    np.testing.assert_array_equal(back.to_params().numpy(), np.asarray(cj.with_params(jnp.asarray(moved.numpy())).to_params()))


@pytest.mark.parametrize("name", MODELS)
def test_convert_calibration_dispatches_on_the_reference_type(name):
    cj, ct = _pair(name, 20 + MODELS.index(name))
    src = jax.tree.map(np.asarray, cj)
    for s in (src, {k: getattr(src, k) for k in src.__dataclass_fields__}):
        got = convert.calibration(s)
        assert type(got).__name__ == name
        np.testing.assert_array_equal(got.to_params().numpy(), ct.to_params().numpy())
        np.testing.assert_array_equal(got.u0.numpy(), ct.u0.numpy())
    assert tcal.CALIBRATION_TYPES[MODELS.index(name)] is type(ct)


def test_fisheye_at_the_principal_point_is_finite():
    cj, ct = _pair("Cal3Fisheye", 30)
    zero = np.zeros((N, 2), np.float32)
    uv_t = ct.uncalibrate(torch.as_tensor(zero))
    _close(uv_t.numpy(), np.asarray(cj.uncalibrate(jnp.asarray(zero))))
    np.testing.assert_allclose(ct.calibrate(uv_t).numpy(), zero, atol=1e-6)
    # d uv / d p at p = 0 is K's upper 2x2 (theta_d(r) / r -> 1)
    J = jacobian_fwd(ct.uncalibrate, torch.as_tensor(zero))
    assert torch.isfinite(J).all()
    np.testing.assert_allclose(J.numpy(), ct.K()[:, :2, :2].numpy(), rtol=1e-6)
    Jc = jacobian_fwd(ct.calibrate, uv_t)
    assert torch.isfinite(Jc).all()
    np.testing.assert_allclose(Jc.numpy(), torch.linalg.inv(ct.K()[:, :2, :2]).numpy(), rtol=1e-4, atol=1e-9)
    # and through the parameters, as bundle adjustment differentiates them
    Jp = jacobian_fwd(lambda q: ct.with_params(q).uncalibrate(torch.as_tensor(zero)), ct.to_params())
    assert torch.isfinite(Jp).all()
