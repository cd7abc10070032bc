"""Masked-language-model pretraining over the shared encoder -- the port of
``nbest_asr_tpu/train/mlm.py`` (``init_mlm_head_params`` :37,
``mlm_head_export_state`` :50, ``apply_mlm_mask`` :70, ``mlm_loss`` :88,
``make_mlm_train_step`` :114).

Standard BERT MLM: 15% of the maskable positions are selected each step,
of which 80% become ``[MASK]``, 10% a random id and 10% stay.  The
prediction head is dense (h -> h), GELU, LayerNorm, then the decoder tied
to the word-embedding table plus a free output bias -- HF's
``cls.predictions.*`` layout, so the head exports beside the encoder
(``models/hf_convert.export_hf_checkpoint``) and the checkpoint feeds
``--tod_pre_trained_model``.

The masks are drawn on the batch's device from a ``torch.Generator``
there; the step draws that generator's seed and the dropout seed from
the caller's generator, as ``make_train_step`` draws its dropout seeds.
The encoder runs in training mode, so with ``use_fused_attn`` and
``use_fused_ffn`` on the card it runs both blocks' kernel chains forward
and backward.  The decoder is a plain ``torch.matmul`` against the tied
table in f32, as JAX's ``jnp.dot(..., preferred_element_type=f32)``
outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..models.encoder import EncoderConfig, encoder_forward
from ..ops.layers import acc_dtype, dense, gelu, layer_norm
from ..ops.philox import generator
from .optimizer import apply_updates, tree_leaves, tree_map

MLM_IGNORE = -1  # label id for unmasked positions


def init_mlm_head_params(gen: torch.Generator, cfg: EncoderConfig) -> dict:
    """The head's params on the generator's device: a truncated normal
    (+-2 sigma) times ``initializer_range`` for the transform kernel,
    zero biases, unit LN scale -- JAX's distribution."""
    h, dev = cfg.hidden_size, gen.device
    k = torch.empty(h, h, dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(k, 0.0, 1.0, -2.0, 2.0, generator=gen)
    f32 = dict(dtype=torch.float32, device=dev)
    return {
        "transform_kernel": k.mul_(cfg.initializer_range),
        "transform_bias": torch.zeros(h, **f32),
        "ln_scale": torch.ones(h, **f32),
        "ln_bias": torch.zeros(h, **f32),
        "decoder_bias": torch.zeros(cfg.vocab_size, **f32),
    }


def mlm_head_export_state(head: dict, word_emb: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
    """Head params -> HF ``cls.predictions.*`` tensors (CPU f32, torch's
    (out, in) layout) for ``export_hf_checkpoint``'s ``extra_state``."""
    def c(t):
        return t.detach().to("cpu", torch.float32).clone()

    return {
        "cls.predictions.transform.dense.weight":
            c(head["transform_kernel"]).t().contiguous(),
        "cls.predictions.transform.dense.bias": c(head["transform_bias"]),
        "cls.predictions.transform.LayerNorm.weight": c(head["ln_scale"]),
        "cls.predictions.transform.LayerNorm.bias": c(head["ln_bias"]),
        "cls.predictions.bias": c(head["decoder_bias"]),
        "cls.predictions.decoder.weight": c(word_emb),
        "cls.predictions.decoder.bias": c(head["decoder_bias"]),
    }


def apply_mlm_mask(gen: torch.Generator, input_ids: torch.Tensor,
                   maskable: torch.Tensor, mask_token_id: int,
                   vocab_size: int, mask_rate: float = 0.15
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (masked ids, labels); labels are ``MLM_IGNORE`` off target.
    Drawn from ``gen``, which lies on the tensors' device."""
    shape, dev = input_ids.shape, input_ids.device
    sel = (torch.rand(shape, generator=gen, device=dev) < mask_rate) \
        & maskable.bool()
    labels = torch.where(sel, input_ids, torch.full_like(input_ids,
                                                         MLM_IGNORE))
    u = torch.rand(shape, generator=gen, device=dev)
    rand_ids = torch.randint(0, vocab_size, shape, generator=gen, device=dev,
                             dtype=input_ids.dtype)
    replacement = torch.where(
        u < 0.8, torch.full_like(input_ids, mask_token_id),
        torch.where(u < 0.9, rand_ids, input_ids))
    return torch.where(sel, replacement, input_ids), labels


def mlm_loss(params: dict, masked_ids: torch.Tensor, labels: torch.Tensor,
             attn_mask: torch.Tensor, segment_ids, cfg: EncoderConfig,
             seed: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean cross-entropy over the masked positions (f32), and their
    count; the encoder in training mode, its dropout keyed on ``seed``."""
    x = encoder_forward(params["encoder"], masked_ids, attn_mask,
                        segment_ids, cfg, deterministic=False, seed=seed)
    head = params["mlm_head"]
    cdt = cfg.cdtype
    h = dense(x, head["transform_kernel"].to(cdt), head["transform_bias"])
    h = layer_norm(gelu(h), head["ln_scale"], head["ln_bias"],
                   cfg.layer_norm_eps)
    acc = acc_dtype(cdt)
    word = params["encoder"]["embeddings"]["word"].to(cdt)     # tied
    logits = torch.matmul(h.to(acc), word.to(acc).t())
    logits = logits + head["decoder_bias"].to(acc)
    on_target = labels != MLM_IGNORE
    safe = torch.where(on_target, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, safe.long()[..., None])[..., 0]
    n_masked = on_target.sum()
    total = torch.where(on_target, nll, torch.zeros_like(nll)).sum()
    return total / n_masked.clamp(min=1), n_masked


def mlm_update(params: dict, opt_state, optimizer, cfg: EncoderConfig,
               masked_ids, labels, attn_mask, segment_ids, seed: int):
    """One optimizer step on the MLM loss of the given masks ->
    (new params, new optimizer state, loss)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)
    loss, _ = mlm_loss(live, masked_ids, labels, attn_mask, segment_ids, cfg,
                       seed)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))]
    it = iter(grads)
    with torch.no_grad():
        updates, opt_state = optimizer.update(
            tree_map(lambda _: next(it), params), opt_state, params)
        new_params = apply_updates(params, updates)
    return new_params, opt_state, loss.detach()


def make_mlm_train_step(cfg: EncoderConfig, optimizer, mask_token_id: int,
                        mask_rate: float = 0.15):
    """Returns ``step(params, opt_state, batch, gen) -> (params, opt_state,
    loss)``: ``batch`` holds input_ids, attn_mask, segment_ids and the
    bool ``maskable`` on one device; ``gen`` (a CPU ``torch.Generator``)
    seeds this step's masks and dropout, fresh every call."""

    def step(params, opt_state, batch, gen: torch.Generator):
        ids = batch["input_ids"]
        mask_seed, drop_seed = (int(s) for s in torch.randint(
            0, 2 ** 62, (2,), generator=gen, device=gen.device))
        masked, labels = apply_mlm_mask(
            generator(mask_seed, ids.device), ids, batch["maskable"],
            mask_token_id, cfg.vocab_size, mask_rate)
        return mlm_update(params, opt_state, optimizer, cfg, masked, labels,
                          batch["attn_mask"], batch["segment_ids"],
                          drop_seed)

    return step
