"""What the port's tool tests (``tests/test_torch_tools_*.py``) share: the
JAX package's tools loaded from ``tools/`` as modules, a synthetic
stand-in for the reference's processed DSTC2 directory, a tiny BERT
checkpoint for ``--tod_pre_trained_model``, and the bridge that gives the
port's Trainer the head JAX's draws."""

import importlib.util
import os
import sys

import jax
import pytest
import torch

from chip_smoke import write_ref_raw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BERT_VOCAB = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
# what both CLIs train with under --extra: the tiny checkpoint, no
# dropout, f32 (JAX's head bridged in), so that their epochs agree
EXTRA = "--tod_pre_trained_model {} --require_pretrained --dropout 0 " \
        "--bert_dropout 0 --compute_dtype float32"


@pytest.fixture
def one_thread():
    """torch on one CPU thread for the test: the suite's workers share the
    machine's cores, and many threads each slow every worker down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name: str):
    """``tools/<name>.py`` of the JAX package, imported as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def ref_raw(tmp_path_factory, n_sessions: int = 200, seed: int = 17) -> str:
    """A REF_RAW: ``valid`` / ``train`` / ``test`` shards from synthetic
    DSTC2 sessions through the port's ETL, and a reference-format
    ``memory.pt``."""
    return write_ref_raw(str(tmp_path_factory.mktemp("ref")), n_sessions,
                         seed)


def tod_checkpoint(raw: str, path) -> str:
    """A tiny BERT checkpoint as ``--tod_pre_trained_model`` takes it
    (``BertModel.save_pretrained`` and ``BertTokenizer.save_pretrained``,
    ``[SYS]`` / ``[USR]`` added), its vocab the memory's words."""
    from transformers import BertConfig, BertModel, BertTokenizer

    from nbest_asr_tpu_torch.data.vocab import Memory

    memory = Memory.load(os.path.join(raw, "memory.json"))
    words = sorted(w for w in memory.word2idx if w.isalpha())
    os.makedirs(path, exist_ok=True)
    vocab = os.path.join(path, "vocab.txt")
    with open(vocab, "w") as fp:
        fp.write("\n".join(BERT_VOCAB + words) + "\n")
    tok = BertTokenizer(vocab)
    tok.add_special_tokens({"additional_special_tokens": ["[SYS]", "[USR]"]})
    tok.save_pretrained(str(path))
    torch.manual_seed(11)
    model = BertModel(BertConfig(
        vocab_size=len(BERT_VOCAB) + len(words), hidden_size=32,
        num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
        max_position_embeddings=512), add_pooling_layer=False)
    model.save_pretrained(str(path))
    return str(path)


def bridge_jax_head(monkeypatch, seed: int) -> None:
    """The port's Trainer starts from the head JAX's ``build_model`` draws
    for ``--random_seed seed`` (under the CLI's rbg PRNG)."""
    from nbest_asr_tpu.models import heads as jheads
    from nbest_asr_tpu_torch.params_bridge import from_jax_numpy
    from nbest_asr_tpu_torch.train import loop as tloop

    def jax_head(gen, hidden, n_top, n_bottom):
        saved = jax.config.jax_default_prng_impl
        jax.config.update("jax_default_prng_impl", "rbg")
        try:
            _, k_head = jax.random.split(jax.random.PRNGKey(seed))
            head = jheads.init_head_params(k_head, hidden, n_top, n_bottom)
            return from_jax_numpy(jax.device_get(head))
        finally:
            jax.config.update("jax_default_prng_impl", saved)

    monkeypatch.setattr(tloop, "init_head_params", jax_head)


def run_jax_tool(mod, argv, monkeypatch, tmp_path) -> int:
    """``mod.main()`` with ``argv`` as its command line, its process-wide
    PRNG and compile-cache settings put back."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_default_prng_impl", "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    monkeypatch.setenv("NBEST_ASR_TPU_CACHE", str(tmp_path / "jax_cache"))
    monkeypatch.setattr(sys, "argv", [mod.__file__, *argv])
    try:
        return mod.main()
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
