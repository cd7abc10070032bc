"""nbest_asr_tpu_torch -- the PyTorch + CUDA port of ``nbest_asr_tpu``.

The JAX package beside it is the reference.  This package mirrors its
module paths, imports ``torch`` and never ``jax`` or ``nbest_asr_tpu``
(it keeps its own copies of the framework-free host code it needs:
``constants.py`` and ``data/``), and replaces every Pallas kernel on its
path with a kernel written by hand for Hopper (``csrc/``, built with
nvcc on first use).  Slices so far: the bf16 and int8 serving forwards
(``Predictor``) and the bf16 fine-tune train step
(``parallel.train_step.make_train_step``).
"""

__version__ = "0.1.0"

_EXPORTS = {
    "Predictor": ".serve",
    "EncoderConfig": ".models.encoder",
    "ModelConfig": ".models.model",
}


def __getattr__(name):
    # lazy top-level API: a bare import stays light
    if name in _EXPORTS:
        import importlib

        return getattr(importlib.import_module(_EXPORTS[name], __name__),
                       name)
    raise AttributeError(name)
