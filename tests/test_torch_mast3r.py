"""The port's MASt3R correspondence generator against the reference.

- ``MASt3RNet.symmetric_inference`` at reduced widths (encoder 64 wide, 2
  blocks of 4 heads; decoders 48 wide, 2 blocks; 8-d descriptors) on a
  seeded smooth pair, the reference's ``init_params`` carried across by
  ``convert.mast3r_state_dict``: the four descriptor maps and confidences
  within 1e-4.
- ``reciprocal_nn`` on the reference's descriptor maps: at least 99% of
  the seeds end on the same (A, B) pair with the same convergence flag
  (argmax hops are float32 decisions).
- ``_preprocess``: the antialiased resize to the long edge within 1e-5 of
  ``jax.image.resize``, and the same scale back to the original pixels.
- The generator on 3 pairs of 3 images: at least 99% of the reference's
  correspondences (as pixel pairs) identical.
- The official layout: a checkpoint ``{"model": state_dict}`` written from
  the reference's params loads in both packages with the same options
  read off its shapes, and gives the same correspondences.
- A direct-branch run of the mast3r config at the reduced widths (long
  edge 128) through both packages' scene optimizers (test_torch_correspondence's
  ``direct_runs`` and folder): registered equal, AUC@5 within 0.02,
  correspondences per pair within 2 + 3%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gtsfm_tpu.frontend import mast3r as jm
from gtsfm_tpu_torch.frontend import mast3r as tm
from gtsfm_tpu_torch.utils import convert
from tests.test_torch_loftr import smooth_pair
from tests.test_torch_correspondence import direct_runs, folder  # noqa: F401 (the fixture)
from tests.torch_threads import cap_threads, threads

cap_threads()

TOL = 1e-4
SHARE = 0.99
SMALL = dict(enc_dim=64, enc_depth=2, enc_heads=4, dec_dim=48, dec_depth=2, dec_heads=4, local_feat_dim=8,
             long_edge=64, max_correspondences=256, nn_iterations=3)


def _params(opts, seed=0):
    return jm.init_params(jax.random.PRNGKey(seed), jm.MASt3ROptions(**opts._asdict()))


def _images(n=3, hw=(60, 80)):
    a, b = smooth_pair(hw=hw, seed=4, shift=(2, 3))
    c, _ = smooth_pair(hw=hw, seed=4, shift=(4, 6))
    return [a, b, c][:n]


def _corr_sets(out):
    return {k: {tuple(p) + tuple(q) for p, q in zip(v[0].tolist(), v[1].tolist())} for k, v in out.items()}


def test_symmetric_inference_and_reciprocal_nn_against_reference():
    opts = tm.MASt3ROptions(**SMALL)
    params = _params(opts)
    net = tm.Mast3rCorrespondenceGenerator(opts, state_dict=convert.mast3r_state_dict(jax.tree.map(np.asarray, params)),
                                           device="cpu").net
    im0, im1 = smooth_pair(hw=(48, 64), seed=5)
    x0, x1 = (np.repeat(a[..., None], 3, -1) * 2.0 - 1.0 for a in (im0, im1))
    jd, jc = jm.symmetric_inference(params, jnp.asarray(x0)[None], jnp.asarray(x1)[None],
                                    jm.MASt3ROptions(**opts._asdict()))
    with torch.no_grad():
        td, tc = net.symmetric_inference(*(torch.as_tensor(a.transpose(2, 0, 1))[None] for a in (x0, x1)))
    for g, w in zip(td + tc, jd + jc):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=0)
    A, B = np.array(jd[0][0]), np.array(jd[1][0])
    want = [np.asarray(a) for a in jm.reciprocal_nn(jnp.asarray(A), jnp.asarray(B), 8, opts.nn_iterations)]
    got = [a.numpy() for a in tm.reciprocal_nn(torch.as_tensor(A), torch.as_tensor(B), 8, opts.nn_iterations)]
    same = (got[0] == want[0]) & (got[1] == want[1]) & (got[2] == want[2])
    assert same.mean() >= SHARE and want[2].any()


def test_preprocess_resize_against_reference():
    opts = tm.MASt3ROptions(**SMALL)
    gen = tm.Mast3rCorrespondenceGenerator(opts, device="cpu")
    jgen = jm.Mast3rCorrespondenceGenerator(jm.MASt3ROptions(**opts._asdict()), params={})
    image = _images(1)[0]
    got, g_scale = gen._preprocess(image)
    want, w_scale = jgen._preprocess(image)
    assert g_scale == w_scale and got.shape == (1, 3, 48, 64)
    np.testing.assert_allclose(got[0].numpy().transpose(1, 2, 0), np.asarray(want), atol=1e-5, rtol=0)


def _generate_both(opts, jparams, tgen):
    images = _images()
    pairs = np.array([[0, 1], [0, 2], [1, 2]])
    want = jm.Mast3rCorrespondenceGenerator(jm.MASt3ROptions(**opts._asdict()), params=jparams).generate(images,
                                                                                                          pairs)
    got = tgen.generate(images, pairs)
    assert set(got) == set(want) == {(0, 1), (0, 2), (1, 2)}
    g, w = _corr_sets(got), _corr_sets(want)
    for k in w:
        assert len(w[k]) > 0 and len(g[k] & w[k]) >= SHARE * max(len(g[k]), len(w[k])), k
        assert got[k][0].dtype == np.float32


def test_generator_against_reference():
    opts = tm.MASt3ROptions(**SMALL)
    params = _params(opts, seed=1)
    tgen = tm.Mast3rCorrespondenceGenerator(opts, state_dict=convert.mast3r_state_dict(
        jax.tree.map(np.asarray, params)), device="cpu")
    _generate_both(opts, params, tgen)


def test_official_layout_checkpoint(tmp_path):
    opts = tm.MASt3ROptions(**SMALL)
    sd = convert.mast3r_state_dict(jax.tree.map(np.asarray, _params(opts, seed=2)))
    path = tmp_path / "MASt3R_ViTLarge_BaseDecoder_512_catmlpdpt_metric.pth"
    torch.save({"model": dict(sd, **{"downstream_head1.dpt.head.0.weight": torch.zeros(2)})}, str(path))
    jparams, jopts = jm.load_torch_weights(str(path), jm.MASt3ROptions(**opts._asdict()))
    tgen = tm.Mast3rCorrespondenceGenerator(opts, weights_path=str(path), device="cpu")
    assert tgen.options._asdict() == jopts._asdict()
    assert (tgen.options.enc_heads, tgen.options.local_feat_dim) == (1, 8)  # 64 wide: heads of 64
    _generate_both(tgen.options, jparams, tgen)


@threads(4)
def test_mast3r_direct_run(folder):
    def share(so_t, so_j):
        so_t.correspondence.net.load_state_dict(
            convert.mast3r_state_dict(jax.tree.map(np.asarray, so_j.correspondence.params)))

    small = [f"correspondence.{k}={v}" for k, v in dict(SMALL, long_edge=128).items()]
    out = direct_runs(folder["data"], "mast3r", small, share_weights=share)
    assert sum(out["counts"]["jax"].values()) > 0
