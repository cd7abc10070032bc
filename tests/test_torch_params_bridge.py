"""Parameter bridge: the JAX params pytree -> the port's tensors -> numpy
is exact, and the port's own init matches the JAX init in layout,
dtypes and distribution."""

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from nbest_asr_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nbest_asr_tpu.models.model import ModelConfig as JModelConfig
from nbest_asr_tpu.models.model import init_model_params as j_init
from nbest_asr_tpu_torch.models.encoder import EncoderConfig
from nbest_asr_tpu_torch.models.model import ModelConfig, init_model_params
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy, to_numpy


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@pytest.fixture(scope="module")
def jax_params():
    cfg = JModelConfig(encoder=JEncoderConfig.tiny(vocab_size=97),
                       n_top=6, n_bottom=11)
    return jax.device_get(j_init(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_round_trip_is_exact(jax_params, dtype):
    tree = jax.tree.map(
        lambda a: np.asarray(a).astype(getattr(ml_dtypes, dtype)
                                       if dtype == "bfloat16" else dtype),
        jax_params)
    ported = from_jax_numpy(tree)
    back = to_numpy(ported)
    flat_in, flat_t, flat_out = _flat(tree), _flat(ported), _flat(back)
    assert flat_in.keys() == flat_t.keys() == flat_out.keys()
    want_t = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    for k, a in flat_in.items():
        assert flat_t[k].dtype == want_t, k
        assert tuple(flat_t[k].shape) == a.shape, k
        assert flat_out[k].dtype == a.dtype, k
        np.testing.assert_array_equal(flat_out[k].view(np.uint8),
                                      a.view(np.uint8), err_msg=k)


def test_port_init_matches_jax_layout_and_statistics(jax_params):
    cfg = ModelConfig(encoder=EncoderConfig.tiny(vocab_size=97),
                      n_top=6, n_bottom=11)
    ported = _flat(to_numpy(init_model_params(
        torch.Generator().manual_seed(0), cfg)))
    ref = _flat(jax_params)
    assert ported.keys() == ref.keys()
    for k, a in ref.items():
        p = ported[k]
        assert p.shape == a.shape and p.dtype == a.dtype, k
        if a.std() == 0:                     # biases, LN scales/offsets
            np.testing.assert_array_equal(p, a, err_msg=k)
            continue
        # truncated normal (+-2 sigma of 0.02) for the encoder, U(+-1/
        # sqrt(hidden)) for the head: both inside the same bound; the
        # same moments on leaves of >= 256 draws, where 0.15 of the std
        # is over 3 standard errors of the sample std
        bound = 1 / 8 if k.startswith("head/") else 2 * 0.02
        assert np.abs(a).max() <= bound and np.abs(p).max() <= bound, k
        if a.size >= 256:
            assert abs(p.std() - a.std()) < 0.15 * a.std(), k
            assert abs(p.mean()) < 0.15 * a.std(), k
