"""The port's ``make_train_step`` against the JAX package's on the CPU:
the same bridged parameters, batch and BertAdam settings at dropout 0,
three steps (step 0 trains at lr 0 under the warmup-linear schedule, so
one step would compare zero deltas), two accumulated micros per step,
one with a padding-sentinel row.  Configurations: a hidden-64 model on
the plain route, a hidden-128 model whose FFN blocks take the fused route
(``use_fused_ffn=True, use_fused_attn=False``; JAX runs its Pallas FFN in
interpret mode, the port its kernels' plain versions and the FFN
autograd Function), the same model with both blocks fused
(``use_fused_attn=True`` as well: JAX's attention megakernel against the
port's attention Function), each fused configuration also on packed
micros, the int8 training routes, and the flash route
(``use_flash_attention`` with ``flash_min_seq=16`` so that the tests'
24-token rows route: JAX's single-block flash kernels against the port's
``ops/flash_attention.py``) at head dim 64 beside the fused FFN, at
head dim 32, where the attention megakernel's lane rule fails and JAX
takes flash although ``use_fused_attn`` is set, and at head dim 192 with
the megakernel off (hidden 384, 2 heads: the CLI's 768 / 4 heads under
``--no_fused_attn``, halved).

Tolerances, f32 on both sides: loss parts 1e-5 relative and per-leaf
parameter deltas 1e-3 of the leaf's largest delta (summation order and
the Pallas side's A&S erf move values by ~1e-6 relative; BertAdam's
m / sqrt(v) amplifies that only where a gradient is near 0); the F1
counters are integers and must be equal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.data.packing import pack_train_data
from nbest_asr_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nbest_asr_tpu.models.heads import hierarchy_device_arrays as j_hier
from nbest_asr_tpu.models.model import ModelConfig as JModelConfig
from nbest_asr_tpu.models.model import init_model_params as j_init
from nbest_asr_tpu.parallel.train_step import TrainState as JTrainState
from nbest_asr_tpu.parallel.train_step import \
    make_eval_step as j_make_eval_step
from nbest_asr_tpu.parallel.train_step import \
    make_train_step as j_make_train_step
from nbest_asr_tpu.train.losses import LossConfig as JLossConfig
from nbest_asr_tpu.train.optimizer import OptimizerConfig as JOptConfig
from nbest_asr_tpu.train.optimizer import make_optimizer as j_make_opt
from nbest_asr_tpu_torch.models.encoder import EncoderConfig
from nbest_asr_tpu_torch.models.heads import hierarchy_device_arrays
from nbest_asr_tpu_torch.models.model import ModelConfig
from nbest_asr_tpu_torch.ops import _cuda
from nbest_asr_tpu_torch.parallel.train_step import (TrainState,
                                                     make_eval_step,
                                                     make_train_step)
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy, to_numpy
from nbest_asr_tpu_torch.train.losses import LossConfig
from nbest_asr_tpu_torch.train.optimizer import (OptimizerConfig,
                                                 make_optimizer)

VOCAB, SEQ, MICRO_B, N_ACCUM, STEPS = 60, 24, 4, 2, 3
OPT = dict(optim_choice="bertadam", lr=1e-3, bert_lr=5e-4,
           warmup_proportion=0.1, t_total=10)
CONFIGS = {
    "plain": dict(hidden_size=64, num_heads=4, intermediate_size=128),
    "fused_ffn": dict(hidden_size=128, num_heads=2, intermediate_size=256,
                      use_fused_ffn=True, use_fused_attn=False),
    "fused_attn": dict(hidden_size=128, num_heads=2, intermediate_size=256,
                       use_fused_ffn=True, use_fused_attn=True),
    "fused_attn_int8": dict(hidden_size=128, num_heads=2,
                            intermediate_size=256, use_fused_ffn=True,
                            use_fused_attn=True, use_int8_train=True,
                            use_int8_train_attn=True),
    "fused_attn_int8_bwd": dict(hidden_size=128, num_heads=2,
                                intermediate_size=256, use_fused_ffn=True,
                                use_fused_attn=True, use_int8_train=True,
                                use_int8_train_attn=True,
                                use_int8_train_bwd=True),
    "flash": dict(hidden_size=128, num_heads=2, intermediate_size=256,
                  use_fused_ffn=True, use_fused_attn=False,
                  use_flash_attention=True, flash_min_seq=16),
    "flash_d32": dict(hidden_size=128, num_heads=4, intermediate_size=256,
                      use_fused_attn=True, use_flash_attention=True,
                      flash_min_seq=16),
    "flash_d192": dict(hidden_size=384, num_heads=2, intermediate_size=256,
                       use_fused_attn=False, use_flash_attention=True,
                       flash_min_seq=16),
}


def _host_data(memory, n, seed):
    """n rows of a padded split: ids, masks, segments, both streams,
    labels with at most one gold member per top group."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(5, VOCAB, (n, SEQ)).astype(np.int32)
    mask = np.ones((n, SEQ), np.float32)
    for r in range(n):
        cut = rng.randint(SEQ // 3, SEQ + 1)
        mask[r, cut:] = 0.0
        ids[r, cut:] = 0
    segs = np.zeros((n, SEQ), np.int32)
    segs[:, SEQ // 2:] = 1
    labels = np.zeros((n, memory.n_bottom), np.float32)
    groups = [sorted(m) for m in memory.top2bottom.values()]
    for r in range(n):
        for g in rng.choice(len(groups), size=rng.randint(0, 4),
                            replace=False):
            labels[r, groups[g][rng.randint(len(groups[g]))]] = 1.0
    return {"input_ids": ids, "attn_mask": mask, "segment_ids": segs,
            "trans_input_ids": ids.copy(), "trans_attn_mask": mask.copy(),
            "trans_segment_ids": segs.copy(), "labels": labels}


def _configs(memory, name, dropout=0.0):
    kw = dict(CONFIGS[name], num_layers=2, max_position=64,
              hidden_dropout=dropout, attn_dropout=dropout,
              compute_dtype="float32")
    j = JModelConfig(encoder=JEncoderConfig(vocab_size=VOCAB, **kw),
                     n_top=memory.n_top, n_bottom=memory.n_bottom,
                     head_dropout=dropout)
    t = ModelConfig(encoder=EncoderConfig(vocab_size=VOCAB, **kw),
                    n_top=memory.n_top, n_bottom=memory.n_bottom,
                    head_dropout=dropout)
    return j, t


def _step_indices(n_rows):
    """STEPS x (N_ACCUM, MICRO_B) row indices; the last micro of step 1
    carries the padding sentinel (index n_rows)."""
    rows = np.arange(STEPS * N_ACCUM * MICRO_B) % n_rows
    idx = rows.reshape(STEPS, N_ACCUM, MICRO_B).astype(np.int32)
    idx[1, 1, -1] = n_rows
    return idx


def _run_jax(jcfg, memory, params, data, idx):
    hier = j_hier(memory.arrays())
    opt = j_make_opt(JOptConfig(**OPT), params)
    step = j_make_train_step(jcfg, JLossConfig(), opt, hier,
                             n_accum=N_ACCUM, dual_stream=False,
                             donate=False)
    state = JTrainState(params=params, opt_state=opt.init(params),
                        step=jnp.zeros([], jnp.int32))
    jdata = {k: jnp.asarray(v) for k, v in data.items()}
    out = []
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        for i in range(STEPS):
            state, stats = step(state, jdata, jnp.asarray(idx[i]),
                                jax.random.PRNGKey(i))
            out.append(jax.device_get(stats))
    return jax.device_get(state.params), out


def _run_port(tcfg, memory, params, data, idx, gen_seed=0):
    hier = hierarchy_device_arrays(memory.arrays())
    tparams = from_jax_numpy(params)
    opt = make_optimizer(OptimizerConfig(**OPT), tparams)
    step = make_train_step(tcfg, LossConfig(), opt, hier, n_accum=N_ACCUM,
                           dual_stream=False)
    state = TrainState(tparams, opt.init(tparams), 0)
    tdata = {k: torch.from_numpy(v) for k, v in data.items()}
    gen = torch.Generator().manual_seed(gen_seed)
    out = []
    for i in range(STEPS):
        state, stats = step(state, tdata, idx[i], gen)
        out.append(stats)
    return state, out


def _compare(params0, jparams, jstats, tstate, tstats):
    for js, ts in zip(jstats, tstats):
        for k, v in js["loss"].items():
            np.testing.assert_allclose(float(ts["loss"][k]), float(v),
                                       rtol=1e-5, err_msg=k)
        for k, v in js["counts"].items():
            assert float(ts["counts"][k]) == float(v), k
    got = to_numpy(tstate.params)

    def walk(a, b, c, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], c[k], f"{path}/{k}")
            return
        dj = np.asarray(b, np.float64) - np.asarray(a, np.float64)
        dt = np.asarray(c, np.float64) - np.asarray(a, np.float64)
        scale = np.abs(dj).max()
        assert scale > 0, f"{path}: no update"
        assert np.abs(dt - dj).max() <= 1e-3 * scale, path

    walk(params0, jparams, got)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_three_steps_match_jax(name, tiny_memory):
    jcfg, tcfg = _configs(tiny_memory, name)
    params = jax.device_get(j_init(jax.random.PRNGKey(3), jcfg))
    data = _host_data(tiny_memory, 20, seed=1)
    idx = _step_indices(20)
    jparams, jstats = _run_jax(jcfg, tiny_memory, params, data, idx)
    _cuda.reset_launch_counts()
    tstate, tstats = _run_port(tcfg, tiny_memory, params, data, idx)
    assert all(v == 0 for v in _cuda.launch_counts.values())
    assert tstate.step == STEPS and tstate.opt_state.step == STEPS
    _compare(params, jparams, jstats, tstate, tstats)


def _packed_micros_match_jax(memory, name):
    jcfg, tcfg = _configs(memory, name)
    params = jax.device_get(j_init(jax.random.PRNGKey(4), jcfg))
    host = _host_data(memory, 30, seed=2)
    for k in ("attn_mask", "trans_attn_mask"):
        host[k][:, SEQ // 2:] = 0.0            # short rows pack well
    packed, _ = pack_train_data(host, capacity=SEQ, max_segs=3)
    n = packed["input_ids"].shape[0]
    idx = _step_indices(n)
    jparams, jstats = _run_jax(jcfg, memory, params, packed, idx)
    tstate, tstats = _run_port(tcfg, memory, params, packed, idx)
    _compare(params, jparams, jstats, tstate, tstats)


def test_packed_micros_match_jax(tiny_memory):
    _packed_micros_match_jax(tiny_memory, "fused_ffn")


def test_packed_micros_fused_attn_match_jax(tiny_memory):
    _packed_micros_match_jax(tiny_memory, "fused_attn")


def test_dropout_step_is_seeded(tiny_memory):
    """With dropout 0.1 on the fused-FFN route the step runs, its loss is
    finite, the same generator seed gives the same step and another seed
    another."""
    _, tcfg = _configs(tiny_memory, "fused_ffn", dropout=0.1)
    jcfg, _ = _configs(tiny_memory, "fused_ffn")
    params = jax.device_get(j_init(jax.random.PRNGKey(5), jcfg))
    data = _host_data(tiny_memory, 20, seed=3)
    idx = _step_indices(20)
    a, sa = _run_port(tcfg, tiny_memory, params, data, idx, gen_seed=1)
    b, _ = _run_port(tcfg, tiny_memory, params, data, idx, gen_seed=1)
    c, _ = _run_port(tcfg, tiny_memory, params, data, idx, gen_seed=2)
    for s in sa:
        assert all(np.isfinite(float(v)) for v in s["loss"].values())
    wa = a.params["encoder"]["layers"]["ffn_in_kernel"]
    assert torch.equal(wa, b.params["encoder"]["layers"]["ffn_in_kernel"])
    assert not torch.equal(wa,
                           c.params["encoder"]["layers"]["ffn_in_kernel"])


def _one_step(tiny_memory, seed, **flags):
    """One port train step on the fused-FFN configuration with ``flags``
    (packed micros if ``packed``; parameters of the widths the flags
    set); returns its loss parts."""
    flags = dict(flags)
    packed = flags.pop("packed", False)
    jcfg, tcfg = _configs(tiny_memory, "fused_ffn")
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, **flags))
    params = from_jax_numpy(jax.device_get(j_init(jax.random.PRNGKey(seed),
                                                  jcfg)))
    host = _host_data(tiny_memory, 9, seed=seed)
    if packed:
        host, _ = pack_train_data(host, capacity=SEQ, max_segs=3)
        assert "position_ids" in host
    data = {k: torch.from_numpy(v) for k, v in host.items()}
    cfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(
        tcfg.encoder, **flags))
    opt = make_optimizer(OptimizerConfig(**OPT), params)
    step = make_train_step(cfg, LossConfig(), opt,
                           hierarchy_device_arrays(tiny_memory.arrays()),
                           n_accum=1, dual_stream=False)
    state = TrainState(params, opt.init(params), 0)
    return step(state, data, np.arange(4)[None],
                torch.Generator().manual_seed(0))[1]["loss"]


# one step at a constant lr (step 0 of warmup-linear trains at lr 0),
# eps = 1 (BertAdam's first update linear in the gradient) and no weight
# decay, as chip_smoke.py's dropout-0 gate steps
ONE_STEP_OPT = dict(optim_choice="bertadam", lr=1e-3, bert_lr=1e-3,
                    schedule="none", eps=1.0, weight_decay=0.0)
# the head dims the port once refused, which the chunked attention family
# serves: JAX's attention megakernel route at d = 320 (hidden 640, 2
# heads; eval too), its flash route at d = 12 (hidden 48, 4 heads; d % 8
# != 0), both at the tests' 24-token rows
CHUNKED_HEADS = {"megakernel_d320": dict(use_fused_attn=True,
                                         use_fused_attn_eval=True,
                                         hidden_size=640, num_heads=2),
                 "flash_d12": dict(use_flash_attention=True,
                                   flash_min_seq=16, hidden_size=48,
                                   num_heads=4)}


def _eval_and_one_step_match_jax(memory, flags, seed):
    """An eval step and one training step of JAX's and the port's on the
    same bridged parameters and micro: loss parts within 1e-2 relative,
    every leaf's parameter delta within 5e-2 of JAX's largest for that
    leaf (PERF.md section 2)."""
    jcfg, tcfg = _configs(memory, "fused_ffn")
    jcfg = dataclasses.replace(jcfg, encoder=dataclasses.replace(
        jcfg.encoder, **flags))
    tcfg = dataclasses.replace(tcfg, encoder=dataclasses.replace(
        tcfg.encoder, **flags))
    params = jax.device_get(j_init(jax.random.PRNGKey(seed), jcfg))
    host = _host_data(memory, 9, seed=seed)
    idx = np.arange(8, dtype=np.int32).reshape(2, 4)
    jdata = {k: jnp.asarray(v) for k, v in host.items()}
    tdata = {k: torch.from_numpy(v) for k, v in host.items()}
    jopt = j_make_opt(JOptConfig(**ONE_STEP_OPT), params)
    jstep = j_make_train_step(jcfg, JLossConfig(), jopt,
                              j_hier(memory.arrays()), n_accum=2,
                              dual_stream=False, donate=False)
    with pltpu.force_tpu_interpret_mode(), \
            jax.default_matmul_precision("highest"):
        jev = j_make_eval_step(jcfg, JLossConfig(), j_hier(memory.arrays()))(
            params, jdata, jnp.asarray(np.arange(9)))
        jstate, jstats = jstep(
            JTrainState(params=params, opt_state=jopt.init(params),
                        step=jnp.zeros([], jnp.int32)),
            jdata, jnp.asarray(idx), jax.random.PRNGKey(0))
    tparams = from_jax_numpy(params)
    hier = hierarchy_device_arrays(memory.arrays())
    topt = make_optimizer(OptimizerConfig(**ONE_STEP_OPT), tparams)
    _cuda.reset_launch_counts()
    tev = make_eval_step(tcfg, LossConfig(), hier)(tparams, tdata,
                                                   np.arange(9))
    tstate, tstats = make_train_step(tcfg, LossConfig(), topt, hier,
                                     n_accum=2, dual_stream=False)(
        TrainState(tparams, topt.init(tparams), 0), tdata, idx,
        torch.Generator().manual_seed(0))
    assert all(v == 0 for v in _cuda.launch_counts.values())
    for what, js, ts in (("eval", jev, tev), ("train", jstats, tstats)):
        for k, v in js["loss"].items():
            np.testing.assert_allclose(float(ts["loss"][k]), float(v),
                                       rtol=1e-2, err_msg=f"{what} {k}")
    got = to_numpy(tstate.params)

    def walk(a, b, c, path=""):
        if isinstance(a, dict):
            for k in a:
                walk(a[k], b[k], c[k], f"{path}/{k}")
            return
        dj = np.asarray(b, np.float64) - np.asarray(a, np.float64)
        dt = np.asarray(c, np.float64) - np.asarray(a, np.float64)
        scale = np.abs(dj).max()
        assert scale > 0, f"{path}: no update"
        assert np.abs(dt - dj).max() <= 5e-2 * scale, path

    walk(params, jax.device_get(jstate.params), got)


def test_eval_step_and_training_refusals(tiny_memory):
    """The eval step runs; and where the port once refused -- JAX's
    attention megakernel at head dim 320 and its flash route at head dim
    12, whose heads the chunked attention family now serves -- the port
    refuses nothing: an eval step and one training step at each match
    JAX's (``_eval_and_one_step_match_jax``)."""
    jcfg, tcfg = _configs(tiny_memory, "fused_ffn")
    params = from_jax_numpy(jax.device_get(j_init(jax.random.PRNGKey(6),
                                                  jcfg)))
    data = {k: torch.from_numpy(v)
            for k, v in _host_data(tiny_memory, 9, seed=4).items()}
    hier = hierarchy_device_arrays(tiny_memory.arrays())
    ev = make_eval_step(tcfg, LossConfig(), hier)(params, data,
                                                  np.arange(10))
    assert ev["pred"].shape == (10, tiny_memory.n_bottom)
    assert float(ev["counts"]["total"]) == 9.0
    for seed, flags in enumerate(CHUNKED_HEADS.values()):
        _eval_and_one_step_match_jax(tiny_memory, flags, 6 + seed)


@pytest.mark.parametrize("flags", [
    # seq 24 < flash_min_seq 160: JAX's plain XLA attention
    dict(use_flash_attention=True),
    # both megakernels take every layer: JAX never reads the flags
    dict(use_fused_attn=True, use_fused_ln=True, use_fused_gelu=True),
    # packed rows carry position_ids: JAX's plain embedding
    dict(use_fused_embedding=True, packed=True),
    # the bf16 FFN route ignores the int8 backward flag, as in JAX
    dict(use_int8_train_bwd=True),
    dict(use_int8_train=True),
    dict(use_fused_attn=True, use_int8_train_attn=True),
    # the plain attention path's residual LayerNorm (and, with
    # use_fused_ffn=False, the FFN's) on the fused LN Function
    dict(use_fused_ln=True),
    # the plain FFN path's bias-GELU on the fused GELU Function
    dict(use_fused_gelu=True, use_fused_ffn=False),
    # unpacked rows carry no position_ids: the fused embedding lookup
    dict(use_fused_embedding=True),
    # JAX's flash route at head dim 16: the port's 32-wide instance,
    # its columns past 16 zeros
    dict(use_flash_attention=True, flash_min_seq=16, hidden_size=64,
         num_heads=4),
], ids=["flash_below_min_seq", "fused_ln_gelu_under_megakernels",
        "fused_embedding_packed", "int8_bwd_alone", "int8_ffn",
        "int8_attn", "fused_ln_plain_blocks", "fused_gelu_plain_ffn",
        "fused_embedding_unpacked", "flash_d16"])
def test_training_steps_where_jax_has_no_unported_kernel(tiny_memory, flags):
    loss = _one_step(tiny_memory, 7, **flags)
    assert all(np.isfinite(float(v)) for v in loss.values())
