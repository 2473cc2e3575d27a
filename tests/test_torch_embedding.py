"""Port fbank and WeSpeaker ResNet against the JAX package on the same numpy
inputs, float32. One case uses m_channels=32, where the JAX side takes its
lane-packed stem and the port its plain convolutions."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.models.fbank import kaldi_fbank as jax_kaldi_fbank
from diarizen_tpu.models.fbank import wespeaker_fbank as jax_wespeaker_fbank
from diarizen_tpu.models.resnet import ResNetConfig as JaxResNetConfig
from diarizen_tpu.models.resnet import init_resnet_params, resnet_forward
from diarizen_tpu_torch.models.convert import resnet_state_dict_from_jax
from diarizen_tpu_torch.models.fbank import kaldi_fbank, wespeaker_fbank
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig

TOL = dict(rtol=1e-4, atol=1e-4)  # float32 reassociation only


@pytest.fixture(scope="module")
def wave():
    return (0.1 * np.random.default_rng(0).standard_normal((2, 32000))).astype(np.float32)


def test_fbank_matches_jax(wave):
    np.testing.assert_allclose(
        kaldi_fbank(torch.from_numpy(wave) * 32768.0).numpy(),
        np.asarray(jax_kaldi_fbank(jnp.asarray(wave) * 32768.0)), **TOL)
    np.testing.assert_allclose(
        wespeaker_fbank(torch.from_numpy(wave)).numpy(),
        np.asarray(jax_wespeaker_fbank(jnp.asarray(wave))), **TOL)


@pytest.mark.parametrize(
    "m_channels,num_blocks", [(8, (1, 2, 1, 1)), (32, (1, 1, 1, 1))],
    ids=["plain-stem", "jax-packed-stem"])
def test_resnet_masked_embeddings_match_jax(wave, m_channels, num_blocks):
    jcfg = JaxResNetConfig(m_channels=m_channels, num_blocks=num_blocks, embed_dim=32)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_map(np.asarray, init_resnet_params(jax.random.PRNGKey(1), jcfg))

    def randomize_bn(p):  # running statistics and affine off the identity
        for key, bn in p.items():
            if "bn" in key:
                c = bn["scale"].shape[0]
                bn.update(scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
                          bias=(0.1 * rng.standard_normal(c)).astype(np.float32),
                          mean=(0.1 * rng.standard_normal(c)).astype(np.float32),
                          var=rng.uniform(0.5, 1.5, c).astype(np.float32))

    randomize_bn(params)
    for li in range(1, 5):
        for bp in params[f"layer{li}"]:
            randomize_bn(bp)
    params["seg1"]["b"] = (0.1 * rng.standard_normal(32)).astype(np.float32)

    fbank = np.array(jax_wespeaker_fbank(jnp.asarray(wave)))  # (2, 198, 80)
    weights = (rng.uniform(size=(2, 3, 50)) > 0.3).astype(np.float32)  # (B, S, T')
    weights[1, 2] = 0.0  # an inactive speaker row

    expected = np.asarray(resnet_forward(params, jcfg, jnp.asarray(fbank), jnp.asarray(weights)))
    model = ResNet(ResNetConfig(m_channels=m_channels, num_blocks=num_blocks, embed_dim=32))
    model.load_state_dict(resnet_state_dict_from_jax(params, jcfg))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(fbank), torch.from_numpy(weights)).numpy()
    assert got.shape == expected.shape == (2, 3, 32)
    np.testing.assert_allclose(got, expected, **TOL)


def test_two_embedding_layers_match_jax(wave):
    """`two_emb_layer`: ReLU, the affine-free BatchNorm `seg_bn_1` and `seg_2`
    after `seg_1`; outputs against JAX, and the port's state dict carried
    back through the JAX package's converter gives the same params."""
    from diarizen_tpu.models.resnet import resnet_params_from_torch

    jcfg = JaxResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=24,
                           two_emb_layer=True, packed_stem=False)
    rng = np.random.default_rng(6)
    params = jax.tree_util.tree_map(np.asarray, init_resnet_params(jax.random.PRNGKey(3), jcfg))
    params["seg1"]["b"] = (0.1 * rng.standard_normal(24)).astype(np.float32)
    params["seg_bn1"] = {"mean": (0.1 * rng.standard_normal(24)).astype(np.float32),
                         "var": rng.uniform(0.5, 1.5, 24).astype(np.float32)}
    params["seg2"] = {"w": (rng.standard_normal((24, 24)) / 5).astype(np.float32),
                      "b": (0.1 * rng.standard_normal(24)).astype(np.float32)}
    fbank = np.array(jax_wespeaker_fbank(jnp.asarray(wave)))
    weights = (rng.uniform(size=(2, 3, 50)) > 0.3).astype(np.float32)
    expected = np.asarray(resnet_forward(params, jcfg, jnp.asarray(fbank), jnp.asarray(weights)))

    model = ResNet(ResNetConfig(m_channels=8, num_blocks=(1, 1, 1, 1), embed_dim=24,
                                two_emb_layer=True))
    model.load_state_dict(resnet_state_dict_from_jax(params, jcfg))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(fbank), torch.from_numpy(weights)).numpy()
    assert got.shape == expected.shape == (2, 3, 24)
    np.testing.assert_allclose(got, expected, **TOL)

    back = resnet_params_from_torch(model.state_dict(), jcfg)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
