"""Out-of-range ids in the embeddings: the port against the JAX package on
the CPU, on both of JAX's paths.

RoBERTa and XLM-R checkpoints carry one token-type row, yet the
``--add_segment_ids`` layout sends segment id 1 into it; an added token
such as ``[SYS]`` may lie past a checkpoint's word table; a row longer
than the position table reads past it.  JAX's plain embedding is an XLA
gather, which clamps every such index into its table
(``nbest_asr_tpu/models/encoder.py:188``, ``:196``), and its gradient an
XLA scatter-add, which drops the rows of those indices.  JAX's fused
lookup (``ops/fused_embed.py``, as its tests run it: interpret mode)
selects the type row with a one-hot product, so an out-of-range type id
reads a zero row; it reads the word row from the table padded to a
multiple of 8 rows, so an id in the padding reads a zero row and one
past it fails; its backward is the plain path's XLA.  The port did otherwise
(its plain path indexed with torch, which raises on the CPU and asserts
on the card; its fused lookup wrote a NaN row); these tests hold it to
JAX's values and gradients on every path."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nbest_asr_tpu.models import encoder as jenc
from nbest_asr_tpu.ops.fused_embed import fused_embed_lookup as j_embed
from nbest_asr_tpu_torch.models import encoder as tenc
from nbest_asr_tpu_torch.ops.fused_embed import fused_embed_lookup
from nbest_asr_tpu_torch.params_bridge import from_jax_numpy

ATOL = 1e-4
V, H, P, T = 21, 128, 40, 1        # V % 8 = 5: ids 21..23 are padding


def _cfgs(**kw):
    base = dict(vocab_size=V, hidden_size=H, num_layers=1, num_heads=2,
                intermediate_size=256, max_position=P, type_vocab_size=T,
                position_offset=2, layer_norm_eps=1e-5, hidden_dropout=0.0,
                attn_dropout=0.0)
    base.update(kw)
    return jenc.EncoderConfig(**base), tenc.EncoderConfig(**base)


def _tables(seed=0):
    rng = np.random.RandomState(seed)
    return {"word": rng.randn(V, H).astype(np.float32),
            "position": rng.randn(P, H).astype(np.float32),
            "type": rng.randn(T, H).astype(np.float32),
            "ln_scale": (1 + 0.1 * rng.randn(H)).astype(np.float32),
            "ln_bias": (0.1 * rng.randn(H)).astype(np.float32)}


# (ids, type ids) of a (2, 8) batch: in range, then out of range
CASES = {
    "type_id_1_into_one_row": ([list(range(3, 11)), list(range(11, 19))],
                               [[0] * 4 + [1] * 4, [1] * 8]),
    "word_ids_past_table": ([[0, 5, V - 1, V, V + 1, V + 2, 4, 6],
                             [V + 2, 1, 2, 3, V, 7, 8, 9]],
                            [[0] * 8, [0] * 8]),
    "both": ([[V, 2, 3, 4, V + 1, 6, 7, 8], [9, 10, V + 2, 12, 13, 14, 15,
                                              16]],
             [[2, 0, 5, 0, 0, 1, 0, 0], [0, 3, 0, 0, 0, 0, 0, 1]]),
}


def _plain_grads(j_tables, ids, tids, jcfg, tcfg, dy):
    """(JAX, port) embedding outputs and table gradients, plain path."""
    def jf(tables):
        return jenc._embed({"embeddings": tables}, ids, tids, jcfg, None,
                           True)

    jy, vjp = jax.vjp(jf, {k: jnp.asarray(v) for k, v in j_tables.items()})
    (jg,) = vjp(jnp.asarray(dy))
    tt = {k: torch.from_numpy(v.copy()).requires_grad_(True)
          for k, v in j_tables.items()}
    ty = tenc._embed({"embeddings": tt}, torch.from_numpy(np.asarray(ids)),
                     torch.from_numpy(np.asarray(tids)), tcfg)
    tg = torch.autograd.grad(ty, list(tt.values()),
                             torch.from_numpy(dy))
    return (np.asarray(jy), ty.detach().numpy(),
            {k: np.asarray(v) for k, v in jg.items()},
            {k: g.numpy() for k, g in zip(tt, tg)})


@pytest.mark.parametrize("case", list(CASES))
def test_plain_embedding_clamps_as_jax(case):
    jcfg, tcfg = _cfgs()
    ids, tids = (np.asarray(a, np.int32) for a in CASES[case])
    dy = np.random.RandomState(1).randn(2, 8, H).astype(np.float32)
    jy, ty, jg, tg = _plain_grads(_tables(), ids, tids, jcfg, tcfg, dy)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], atol=ATOL, err_msg=k)


def test_plain_positions_past_the_table_clamp_as_jax():
    """A row longer than the position table (offset 2): JAX's gather
    reads the last position row for the rest."""
    jcfg, tcfg = _cfgs(max_position=12)
    tables = _tables()
    tables["position"] = tables["position"][:12]
    ids = np.arange(16, dtype=np.int32).reshape(1, 16) % V
    tids = np.zeros_like(ids)
    dy = np.random.RandomState(2).randn(1, 16, H).astype(np.float32)
    jy, ty, jg, tg = _plain_grads(tables, ids, tids, jcfg, tcfg, dy)
    np.testing.assert_allclose(ty, jy, atol=ATOL)
    np.testing.assert_allclose(tg["position"], jg["position"], atol=ATOL)


@pytest.mark.parametrize("case", list(CASES))
def test_fused_lookup_matches_jax_out_of_range(case):
    """Values of JAX's interpret-mode kernel (zero rows) and gradients of
    its XLA backward (clamped reads, dropped scatters)."""
    ids, tids = (np.asarray(a, np.int32) for a in CASES[case])
    tb = _tables(3)
    pos = tb["position"][2:10]
    dy = np.random.RandomState(4).randn(2, 8, H).astype(np.float32)

    def jf(word, pos, type_, scale, bias):
        return j_embed(word, pos, type_, scale, bias, jnp.asarray(ids),
                       jnp.asarray(tids), 8, 1e-5)

    args = [jnp.asarray(a) for a in (tb["word"], pos, tb["type"],
                                     tb["ln_scale"], tb["ln_bias"])]
    with pltpu.force_tpu_interpret_mode():
        jy, vjp = jax.vjp(jf, *args)
        jg = vjp(jnp.asarray(dy))
    targs = [torch.from_numpy(np.asarray(a).copy()).requires_grad_(True)
             for a in args]
    ty = fused_embed_lookup(*targs, torch.from_numpy(ids),
                            torch.from_numpy(tids), 8, 1e-5)
    tg = torch.autograd.grad(ty, targs, torch.from_numpy(dy))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               atol=ATOL)
    for name, a, b in zip(("word", "pos", "type", "scale", "bias"), tg, jg):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("bad_id", [V + 3, V + 40])
def test_fused_lookup_fails_where_jax_fails(bad_id):
    """A word id past the table's padding to 8 rows: JAX's kernel fails
    reading its row group, and so does the port's plain version (on the
    card: a NaN row).  (A negative id reads a row group counted from the
    end in JAX's interpret mode, an artifact of numpy indexing, and
    faults on a TPU; the port fails there too.)"""
    tb = _tables(5)
    ids = np.arange(8, dtype=np.int32).reshape(1, 8)
    ids[0, 3] = bad_id
    tids = np.zeros_like(ids)
    args = [jnp.asarray(a) for a in (tb["word"], tb["position"][:8],
                                     tb["type"], tb["ln_scale"],
                                     tb["ln_bias"])]
    with pytest.raises(Exception):
        with pltpu.force_tpu_interpret_mode():
            np.asarray(j_embed(*args, jnp.asarray(ids), jnp.asarray(tids), 8,
                               1e-5))
    with pytest.raises(IndexError):
        fused_embed_lookup(*[torch.from_numpy(np.asarray(a).copy())
                             for a in args], torch.from_numpy(ids),
                           torch.from_numpy(tids), 8, 1e-5)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_roberta_encoder_with_segment_ids_matches_jax(fused):
    """A RoBERTa-shaped encoder (one type row, offset 2, eps 1e-5) fed
    segment ids 0 and 1 -- the Trainer's ``--add_segment_ids`` rows --
    through each embedding path, forward and input-table gradients."""
    jcfg, tcfg = _cfgs(num_layers=2, use_fused_embedding=fused)
    params = jax.device_get(jenc.init_encoder_params(jax.random.PRNGKey(6),
                                                     jcfg))
    rng = np.random.RandomState(7)
    ids = rng.randint(0, V + 3, (2, 16)).astype(np.int32)
    segs = np.zeros_like(ids)
    segs[:, 6:] = 1
    mask = np.ones_like(ids)
    mask[1, 12:] = 0

    def jf(emb):
        p = dict(params, embeddings=emb)
        return jnp.sum(jenc.encoder_forward(
            p, jnp.asarray(ids), jnp.asarray(mask), jnp.asarray(segs), jcfg,
            deterministic=True) ** 2)

    with pltpu.force_tpu_interpret_mode():
        jl, jg = jax.value_and_grad(jf)(params["embeddings"])
    tp = from_jax_numpy(params)
    emb = {k: v.requires_grad_(True) for k, v in tp["embeddings"].items()}
    tl = (tenc.encoder_forward(dict(tp, embeddings=emb),
                               torch.from_numpy(ids), torch.from_numpy(mask),
                               torch.from_numpy(segs), tcfg) ** 2).sum()
    tg = torch.autograd.grad(tl, list(emb.values()))
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    for k, g in zip(emb, tg):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=ATOL,
                                   err_msg=k)
    assert dataclasses.asdict(tcfg)["use_fused_embedding"] == fused
