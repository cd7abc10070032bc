"""Parameter bridge between the JAX package and the port.

Both packages share one parameter layout (``nbest_asr_tpu/models/
model.py:init_model_params``): a nested dict with GEMM kernels laid out
(in, out) and the per-layer leaves stacked on a leading ``num_layers``
axis.  The bridge is therefore a dict walk with no transposes, and the
round trip is exact.  It takes and returns numpy arrays, so neither side
needs the other's framework (``jax.device_get(params)`` gives the input).

The BertAdam state crosses the same way (``opt_state_from_numpy``,
``opt_state_to_numpy``): its step count and the ``m`` and ``v`` trees,
which share the parameter layout, so a multi-step trajectory can start
from one state on both sides.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .train.optimizer import BertAdamState


def _leaf_to_torch(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # numpy has no bf16; ml_dtypes' bf16 shares torch's bit layout
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a, copy=True))
    return t.to(device)


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def from_jax_numpy(tree: Dict[str, Any], device="cpu") -> Dict[str, Any]:
    """Nested dict of numpy arrays (a JAX params pytree after
    ``jax.device_get``) -> the same nested dict of tensors on
    ``device``, dtypes kept."""
    if isinstance(tree, dict):
        return {k: from_jax_numpy(v, device) for k, v in tree.items()}
    return _leaf_to_torch(tree, device)


def to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The port's nested dict of tensors -> nested dict of numpy arrays
    (what ``jax.numpy.asarray`` takes back)."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    return _leaf_to_numpy(tree)


def opt_state_from_numpy(step, m: Dict[str, Any], v: Dict[str, Any],
                         device="cpu") -> BertAdamState:
    """A BertAdam state (JAX ``BertAdamState(step, m, v)`` after
    ``jax.device_get``) -> the port's ``BertAdamState``."""
    return BertAdamState(step=int(np.asarray(step)),
                         m=from_jax_numpy(m, device),
                         v=from_jax_numpy(v, device))


def opt_state_to_numpy(state: BertAdamState
                       ) -> Tuple[np.ndarray, Dict[str, Any], Dict[str, Any]]:
    """The port's ``BertAdamState`` -> (step as int32, m, v) numpy."""
    return (np.asarray(state.step, np.int32), to_numpy(state.m),
            to_numpy(state.v))
