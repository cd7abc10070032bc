"""The port's data- and tensor-parallel train step over real gloo ranks
on the CPU, against the JAX package's single-device ``make_train_step``.

Each case spawns its ranks (``torch_dist_worker.py steps``: a
``file://`` store, one thread, 120 s each) on JAX's dp-invariance fixture
(``tests/test_dp_invariance.py:24-49``: a tiny encoder at dropout 0, 16
rows of 16 tokens from seed-0 numpy, n_accum 2 x micro 8, the transcript
stream and its MSE term on) and takes three BertAdam steps from JAX's
initial parameters; JAX takes the same three steps on one device.  The
layouts are dp = 2, tp = 2, dp2 x tp2 and dcn2 x tp2 (the mesh's
flattened dp group over dcn x data), and tp = 2 with a clip small enough
to act on every tensor -- BertAdam's per-tensor clip, and adamw's
global-norm clip -- whose norms must be summed over tp.  Tolerances are
JAX's own (``test_dp_invariance.py:84-103``): parameters within 2e-5
abs / rel, the loss parts within rtol 1e-5 and the F1 counters exact, on
every rank (gathered over tp)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from nbest_asr_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nbest_asr_tpu.models.heads import hierarchy_device_arrays
from nbest_asr_tpu.models.model import ModelConfig as JModelConfig
from nbest_asr_tpu.models.model import init_model_params
from nbest_asr_tpu.parallel.train_step import TrainState, make_train_step
from nbest_asr_tpu.train.losses import LossConfig
from nbest_asr_tpu.train.optimizer import OptimizerConfig, make_optimizer
from torch_dist_worker import flat, spawn

ENC = dict(vocab_size=64, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position=320, hidden_dropout=0.0,
           attn_dropout=0.0)
OPT = dict(optim_choice="bertadam", lr=1e-3, bert_lr=1e-3, t_total=100)
# (n_dcn, n_data, n_model, optimizer overrides)
LAYOUTS = {
    "dp2": (1, 2, 1, {}),
    "tp2": (1, 1, 2, {}),
    "dp2_tp2": (1, 2, 2, {}),
    "dcn2_tp2": (2, 1, 2, {}),
    "tp2_clip": (1, 1, 2, dict(max_grad_norm=1e-3)),
    "tp2_adamw_clip": (1, 1, 2, dict(optim_choice="adamw",
                                     max_grad_norm=1e-2)),
}
STEPS = 3


def _fixture(tiny_memory):
    """JAX's ``_setup``: params from PRNGKey(0), 16 x 16 rows from
    RandomState(0)."""
    cfg = JModelConfig(encoder=JEncoderConfig(**ENC),
                       n_top=tiny_memory.n_top,
                       n_bottom=tiny_memory.n_bottom)
    params = jax.device_get(init_model_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.RandomState(0)
    n_rows, s = 16, 16
    labels = np.zeros((n_rows, tiny_memory.n_bottom), np.float32)
    labels[np.arange(n_rows), rng.randint(2, tiny_memory.n_bottom,
                                          n_rows)] = 1
    data = {
        "input_ids": rng.randint(1, 64, (n_rows, s)).astype(np.int32),
        "attn_mask": np.ones((n_rows, s), np.float32),
        "segment_ids": np.zeros((n_rows, s), np.int32),
        "trans_input_ids": rng.randint(1, 64, (n_rows, s)).astype(np.int32),
        "trans_attn_mask": np.ones((n_rows, s), np.float32),
        "trans_segment_ids": np.zeros((n_rows, s), np.int32),
        "labels": labels,
    }
    return cfg, params, data


def _jax_steps(cfg, tiny_memory, params, data, opt):
    optimizer = make_optimizer(OptimizerConfig(**opt), params)
    state = TrainState(params=params, opt_state=optimizer.init(params),
                       step=jnp.zeros([], jnp.int32))
    step = make_train_step(cfg, LossConfig(add_l2_loss=True), optimizer,
                           hierarchy_device_arrays(tiny_memory.arrays()),
                           n_accum=2, dual_stream=True, donate=False)
    idx = jnp.asarray(np.arange(16, dtype=np.int32).reshape(2, 8))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    stats = []
    with jax.default_matmul_precision("highest"):
        for _ in range(STEPS):
            state, st = step(state, jdata, idx, jax.random.PRNGKey(7))
            stats.append(jax.device_get(st))
    return jax.device_get(state.params), stats


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_parallel_steps_match_jax_single_device(layout, tiny_memory,
                                                tmp_path):
    n_dcn, n_data, n_model, over = LAYOUTS[layout]
    opt = dict(OPT, **over)
    cfg, params, data = _fixture(tiny_memory)
    want, want_stats = _jax_steps(cfg, tiny_memory, params, data, opt)

    tiny_memory.save(str(tmp_path / "memory.json"))
    arrays = {f"p/{k}": np.asarray(v) for k, v in flat(params).items()}
    arrays.update({f"d/{k}": v for k, v in data.items()})
    arrays["idx"] = np.tile(np.arange(16, dtype=np.int32).reshape(2, 8),
                            (STEPS, 1, 1))
    spec = dict(memory=str(tmp_path / "memory.json"),
                encoder=dict(ENC, compute_dtype="float32"),
                optimizer=opt, n_dcn=n_dcn, n_data=n_data, n_model=n_model,
                n_accum=2, l2=True)
    world = n_dcn * n_data * n_model
    outs = spawn("steps", world, tmp_path / "ranks", spec, arrays)

    want_flat = {k: np.asarray(v) for k, v in flat(want).items()}
    for rank, (js, got) in enumerate(outs):
        assert js["mesh"] == [rank // n_model, rank % n_model]
        assert sorted(got) == sorted(want_flat)
        for k, v in want_flat.items():
            assert got[k].shape == v.shape, k
            np.testing.assert_allclose(got[k], v, atol=2e-5, rtol=2e-5,
                                       err_msg=f"{layout} rank {rank} {k}")
        for ts, js_ in zip(js["stats"], want_stats):
            for k, v in js_["loss"].items():
                np.testing.assert_allclose(ts["loss"][k], float(v),
                                           rtol=1e-5, err_msg=k)
            for k, v in js_["counts"].items():
                assert ts["counts"][k] == float(v), k
