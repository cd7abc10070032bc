"""The port's MLM pretraining (``nbest_asr_tpu_torch/train/mlm.py``)
against the JAX package's ``nbest_asr_tpu/train/mlm.py`` on the CPU, in
f32 at dropout 0 on a tiny encoder.

- ``apply_mlm_mask``: 15% of the maskable positions selected and no
  other, 80% of them ``[MASK]``, 10% a random id, 10% kept; the same
  generator seed draws the same masks.
- ``mlm_loss`` and its gradients equal JAX's on the same masks (1e-4).
- ``mlm_head_export_state`` equals JAX's; an export with the head loads
  in ``BertForMaskedLM`` with no missing keys and predicts the port's
  logits.
- One BertAdam update (``mlm_update``) equals JAX's step with the masks
  given; ``make_mlm_train_step`` lowers the loss of a fixed batch."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from nbest_asr_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nbest_asr_tpu.models.encoder import init_encoder_params as j_init_enc
from nbest_asr_tpu.train import mlm as jmlm
from nbest_asr_tpu.train.optimizer import OptimizerConfig as JOptConfig
from nbest_asr_tpu.train.optimizer import make_optimizer as j_make_opt
from nbest_asr_tpu_torch.models import hf_convert as thf
from nbest_asr_tpu_torch.models.encoder import (EncoderConfig,
                                                init_encoder_params)
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
from nbest_asr_tpu_torch.train import mlm as tmlm
from nbest_asr_tpu_torch.train.optimizer import (OptimizerConfig,
                                                 make_optimizer)

ATOL = 1e-4
TINY = dict(vocab_size=64, hidden_size=32, num_layers=2, num_heads=2,
            intermediate_size=64, max_position=32, type_vocab_size=2,
            hidden_dropout=0.0, attn_dropout=0.0)
MASK_ID = 4


def _params(seed=0):
    jcfg = JEncoderConfig(**TINY)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    params = jax.device_get({"encoder": j_init_enc(k1, jcfg),
                             "mlm_head": jmlm.init_mlm_head_params(k2, jcfg)})
    # a non-zero decoder bias and head LN, so their gradients are tested
    rng = np.random.RandomState(seed)
    head = params["mlm_head"]
    head["decoder_bias"] = (0.1 * rng.randn(TINY["vocab_size"])).astype(
        np.float32)
    head["ln_scale"] = (1 + 0.1 * rng.randn(TINY["hidden_size"])).astype(
        np.float32)
    return jcfg, EncoderConfig(**TINY), params


def _batch(seed=1, b=4, s=16):
    rng = np.random.RandomState(seed)
    ids = rng.randint(8, TINY["vocab_size"], (b, s)).astype(np.int32)
    mask = np.ones((b, s), np.float32)
    mask[1, 11:] = 0
    mask[3, 6:] = 0
    ids[mask == 0] = 0
    ids[:, 0] = 2
    segs = np.zeros_like(ids)
    segs[:, 8:] = 1
    maskable = (mask > 0) & (ids != 2)
    return dict(input_ids=ids, attn_mask=mask, segment_ids=segs,
                maskable=maskable)


def _masks(batch, seed=2):
    masked, labels = jmlm.apply_mlm_mask(
        jax.random.PRNGKey(seed), jnp.asarray(batch["input_ids"]),
        jnp.asarray(batch["maskable"]), MASK_ID, TINY["vocab_size"], 0.3)
    return np.asarray(masked), np.asarray(labels)


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def test_apply_mlm_mask_rates_and_targets():
    n, s, vocab = 64, 256, 500
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(10, vocab, (n, s), generator=g)
    maskable = torch.rand(n, s, generator=g) > 0.25
    masked, labels = tmlm.apply_mlm_mask(torch.Generator().manual_seed(1),
                                         ids, maskable, MASK_ID, vocab)
    sel = labels != tmlm.MLM_IGNORE
    assert not (sel & ~maskable).any()
    rate = sel.sum().item() / maskable.sum().item()
    assert 0.14 < rate < 0.16, rate
    assert torch.equal(labels[sel], ids[sel])
    assert torch.equal(masked[~sel], ids[~sel])
    frac_mask = (masked[sel] == MASK_ID).float().mean().item()
    frac_kept = (masked[sel] == ids[sel]).float().mean().item()
    frac_rand = 1 - frac_mask - frac_kept
    assert 0.78 < frac_mask < 0.82, frac_mask
    assert 0.085 < frac_kept < 0.12, frac_kept       # 10% + random hits
    assert 0.08 < frac_rand < 0.115, frac_rand
    again = tmlm.apply_mlm_mask(torch.Generator().manual_seed(1), ids,
                                maskable, MASK_ID, vocab)
    assert torch.equal(again[0], masked) and torch.equal(again[1], labels)


def test_mlm_loss_and_gradients_match_jax():
    jcfg, tcfg, params = _params()
    batch = _batch()
    masked, labels = _masks(batch)
    assert (labels != jmlm.MLM_IGNORE).sum() > 4

    def jf(p):
        return jmlm.mlm_loss(p, jnp.asarray(masked), jnp.asarray(labels),
                             jnp.asarray(batch["attn_mask"]),
                             jnp.asarray(batch["segment_ids"]), jcfg,
                             jax.random.PRNGKey(0))

    (jl, jn), jg = jax.value_and_grad(jf, has_aux=True)(params)
    tp = from_jax_numpy(params)
    leaves, tree = jax.tree_util.tree_flatten(tp)
    leaves = [t.requires_grad_(True) for t in leaves]
    live = jax.tree_util.tree_unflatten(tree, leaves)
    tb = _t(batch)
    tl, tn = tmlm.mlm_loss(live, torch.from_numpy(masked),
                           torch.from_numpy(labels), tb["attn_mask"],
                           tb["segment_ids"], tcfg, seed=0)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    tg = torch.autograd.grad(tl, leaves)
    for a, b, path in zip(tg, jax.tree_util.tree_leaves(jg),
                          jax.tree_util.tree_flatten_with_path(jg)[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=str(path[0]))


def test_head_export_matches_jax_and_loads_in_bert_mlm(tmp_path):
    from transformers import BertForMaskedLM

    jcfg, tcfg, params = _params(3)
    tp = from_jax_numpy(params)
    word = tp["encoder"]["embeddings"]["word"]
    got = tmlm.mlm_head_export_state(tp["mlm_head"], word)
    want = jmlm.mlm_head_export_state(params["mlm_head"],
                                      params["encoder"]["embeddings"]["word"])
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    thf.export_hf_checkpoint(tcfg, tp["encoder"], str(tmp_path),
                             extra_state=got)
    model, info = BertForMaskedLM.from_pretrained(
        str(tmp_path), local_files_only=True, output_loading_info=True)
    assert info["missing_keys"] == [] and info["mismatched_keys"] == []
    batch = _batch(4)
    tb = _t(batch)
    from nbest_asr_tpu_torch.models.encoder import encoder_forward
    from nbest_asr_tpu_torch.ops.layers import dense, gelu, layer_norm

    head = tp["mlm_head"]
    x = encoder_forward(tp["encoder"], tb["input_ids"], tb["attn_mask"],
                        tb["segment_ids"], tcfg)
    h = layer_norm(gelu(dense(x, head["transform_kernel"],
                              head["transform_bias"])),
                   head["ln_scale"], head["ln_bias"], tcfg.layer_norm_eps)
    ours = h @ word.t() + head["decoder_bias"]
    with torch.no_grad():
        hf = model(input_ids=tb["input_ids"].long(),
                   attention_mask=tb["attn_mask"].long(),
                   token_type_ids=tb["segment_ids"].long()).logits
    real = tb["attn_mask"].bool()
    np.testing.assert_allclose(ours[real].numpy(), hf[real].numpy(),
                               atol=ATOL)


def test_one_mlm_update_matches_jax():
    jcfg, tcfg, params = _params(5)
    batch = _batch(6)
    masked, labels = _masks(batch, seed=7)
    okw = dict(optim_choice="bertadam", lr=1e-3, bert_lr=2e-3,
               warmup_proportion=0.1, t_total=-1)
    tx = j_make_opt(JOptConfig(**okw), params)

    def jf(p):
        return jmlm.mlm_loss(p, jnp.asarray(masked), jnp.asarray(labels),
                             jnp.asarray(batch["attn_mask"]),
                             jnp.asarray(batch["segment_ids"]), jcfg,
                             jax.random.PRNGKey(0))[0]

    jl, jg = jax.value_and_grad(jf)(params)
    updates, _ = tx.update(jg, tx.init(params), params)
    want = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)

    tp = from_jax_numpy(params)
    opt = make_optimizer(OptimizerConfig(**okw), tp)
    tb = _t(batch)
    new, state, loss = tmlm.mlm_update(
        tp, opt.init(tp), opt, tcfg, torch.from_numpy(masked),
        torch.from_numpy(labels), tb["attn_mask"], tb["segment_ids"], 0)
    assert state.step == 1
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(new),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), b, atol=ATOL)


def test_make_mlm_train_step_learns():
    cfg = EncoderConfig(**dict(TINY, hidden_dropout=0.1, attn_dropout=0.1))
    g = torch.Generator().manual_seed(0)
    params = {"encoder": init_encoder_params(g, cfg),
              "mlm_head": tmlm.init_mlm_head_params(g, cfg)}
    h = cfg.hidden_size
    head = params["mlm_head"]
    assert head["transform_kernel"].shape == (h, h)
    assert head["decoder_bias"].shape == (cfg.vocab_size,)
    assert head["transform_kernel"].abs().max() <= 2 * cfg.initializer_range
    opt = make_optimizer(OptimizerConfig(lr=1e-3, bert_lr=1e-3, t_total=40,
                                         warmup_proportion=0.1), params)
    step = tmlm.make_mlm_train_step(cfg, opt, MASK_ID, mask_rate=0.3)
    batch = _t(_batch(8, b=8, s=24))
    state = opt.init(params)
    gen = torch.Generator().manual_seed(1)
    losses = []
    for _ in range(40):
        params, state, loss = step(params, state, batch, gen)
        losses.append(loss.item())
    assert np.isfinite(losses).all()
    assert np.mean(losses[:5]) > np.log(cfg.vocab_size) - 0.5
    assert np.mean(losses[-5:]) < 0.8 * np.mean(losses[:5]), losses
