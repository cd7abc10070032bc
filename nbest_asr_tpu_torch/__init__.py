"""nbest_asr_tpu_torch -- the PyTorch + CUDA port of ``nbest_asr_tpu``.

The JAX package beside it is the reference.  This package mirrors its
module paths, imports ``torch`` and never ``jax``, reuses the JAX
package's framework-free host code (``nbest_asr_tpu.data`` and
``nbest_asr_tpu.constants``), and replaces every Pallas kernel on its
path with a kernel written by hand for Hopper (``csrc/``, built with
nvcc on first use).  The first slice is the bf16 serving forward:
``Predictor`` over the encoder and the hierarchical head.
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
