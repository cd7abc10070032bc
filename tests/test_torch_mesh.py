"""The port's process mesh and parameter sharding
(``nbest_asr_tpu_torch/parallel/mesh.py``) on the CPU.

- ``_spec_for`` equals JAX's on every leaf of a tiny JAX parameter tree,
  with and without tensor parallelism.
- ``shard_leaf`` then ``unshard_leaf`` is the identity on every leaf at
  T = 1, 2 and 4, with the QKV leaves cut per q / k / v third by heads
  and a word table of 63 rows padded with zero rows to a multiple of T.
- Under T = 2 (two gloo ranks, ``torch_dist_worker.py embed``) the
  vocab-parallel embeddings of ids past the table (63, 70) and negative
  ones read the rows ``take_rows`` reads at T = 1 and drop their
  gradients as it does; the word table's gradient, gathered, and the
  position and type tables' equal T = 1's.
- ``init_distributed`` joins a one-rank gloo group from torchrun's
  environment and leaves an initialised group alone."""

import jax
import numpy as np
import pytest
import torch

from nbest_asr_tpu.models.encoder import EncoderConfig as JEncoderConfig
from nbest_asr_tpu.models.model import ModelConfig as JModelConfig
from nbest_asr_tpu.models.model import init_model_params
from nbest_asr_tpu.parallel.mesh import _spec_for as j_spec_for
from nbest_asr_tpu_torch.models.encoder import EncoderConfig, _embed
from nbest_asr_tpu_torch.parallel import mesh as tmesh
from torch_dist_worker import flat, spawn

ENC = dict(vocab_size=63, hidden_size=64, num_layers=2, num_heads=4,
           intermediate_size=128, max_position=32)


def _jax_params():
    cfg = JModelConfig(encoder=JEncoderConfig(**ENC), n_top=3, n_bottom=7)
    return jax.device_get(init_model_params(jax.random.PRNGKey(0), cfg))


@pytest.mark.parametrize("tensor_parallel", [False, True])
def test_specs_equal_jax(tensor_parallel):
    def check(path, leaf):
        s = "/".join(str(getattr(p, "key", p)) for p in path)
        want = j_spec_for(s, leaf.ndim, tensor_parallel)
        assert tmesh._spec_for(s, leaf.ndim, tensor_parallel) == \
            tuple(want), s
        return leaf

    jax.tree_util.tree_map_with_path(check, _jax_params())


@pytest.mark.parametrize("T", [1, 2, 4])
def test_shard_then_gather_is_identity(T):
    params = {k: torch.from_numpy(np.array(v))
              for k, v in flat(_jax_params()).items()}
    h, hl = ENC["hidden_size"], ENC["hidden_size"] // T
    for path, x in params.items():
        parts = [tmesh.shard_leaf(path, x, T, r) for r in range(T)]
        assert torch.equal(tmesh.unshard_leaf(path, parts, 63), x), path
        if T == 1 or "model" not in tmesh._spec_for(path, x.dim(), True):
            assert all(p is x for p in parts), path
            continue
        for r, part in enumerate(parts):
            if "qkv" in path:           # q_r | k_r | v_r, whole heads
                assert part.shape[-1] == 3 * hl
                for third in range(3):
                    lo = third * h + r * hl
                    assert torch.equal(part[..., third * hl:(third + 1) * hl],
                                       x[..., lo:lo + hl]), path
            elif path.endswith("embeddings/word"):
                rows = -(-63 // T)
                assert part.shape == (rows, h)
                real = x[r * rows:(r + 1) * rows]
                assert torch.equal(part[:len(real)], real)
                assert not part[len(real):].any()       # zero padding
    mesh = tmesh.Mesh(1, 1, 2, 0, 0, None, None)
    assert tmesh.is_tp_sharded("encoder/layers/ffn_out_kernel", mesh)
    assert not tmesh.is_tp_sharded("encoder/layers/ffn_out_bias", mesh)


def test_dp_axes_and_global_batch_as_jax():
    """JAX's 2- and 3-axis meshes on its 8 CPU devices against the port's
    meshes of the same shape: the same batch axes, the same global
    batch."""
    from nbest_asr_tpu.parallel import data_sharding as jds
    from nbest_asr_tpu.parallel import mesh as jmesh
    from nbest_asr_tpu_torch.parallel import data_sharding as tds

    for n_dcn, n_data in ((1, 4), (2, 2)):
        j = jmesh.make_mesh(n_data=n_data, n_model=2, n_dcn=n_dcn)
        t = tmesh.Mesh(n_dcn, n_data, 2, 0, 0, None, None)
        assert tmesh.dp_axes(t) == jmesh.dp_axes(j)
        assert tds.global_batch_size(t, 8) == jds.global_batch_size(j, 8)


def test_out_of_range_word_id_under_tp2(tmp_path):
    cfg = EncoderConfig(**ENC, hidden_dropout=0.0)
    emb = {k[len("encoder/embeddings/"):]: np.array(v)
           for k, v in flat(_jax_params()).items()
           if k.startswith("encoder/embeddings/")}
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 63, (3, 8)).astype(np.int64)
    ids[0, :4] = [62, 63, 70, -1]          # last row, past it, negative
    ids[2, 5] = 31                          # the last row of shard 0
    ids[2, 6] = 32                          # the first row of shard 1
    types = rng.randint(0, 2, (3, 8)).astype(np.int64)
    dy = rng.randn(3, 8, ENC["hidden_size"]).astype(np.float32)

    tab = {k: torch.from_numpy(v).requires_grad_(True)
           for k, v in emb.items()}
    want = _embed({"embeddings": tab}, torch.from_numpy(ids),
                  torch.from_numpy(types), cfg)
    want.backward(torch.from_numpy(dy))

    arrays = {f"e/{k}": v for k, v in emb.items()}
    arrays.update(ids=ids, types=types, dy=dy)
    outs = spawn("embed", 2, tmp_path / "ranks",
                 dict(encoder=dict(ENC, hidden_dropout=0.0), n_model=2),
                 arrays)
    for _, got in outs:
        np.testing.assert_array_equal(got["x"], want.detach().numpy())
        np.testing.assert_array_equal(got["dword"], tab["word"].grad.numpy())
        np.testing.assert_array_equal(got["dtype"], tab["type"].grad.numpy())
        np.testing.assert_array_equal(got["dposition"],
                                      tab["position"].grad.numpy())
    # ids 63 and 70 train nothing: without their positions' gradient the
    # word table's is the same
    quiet = dy.copy()
    quiet[0, 1:3] = 0.0
    tab2 = {k: torch.from_numpy(v).requires_grad_(True)
            for k, v in emb.items()}
    _embed({"embeddings": tab2}, torch.from_numpy(ids),
           torch.from_numpy(types), cfg).backward(torch.from_numpy(quiet))
    np.testing.assert_array_equal(outs[0][1]["dword"],
                                  tab2["word"].grad.numpy())


def test_init_distributed_from_torchrun_env(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "0")     # a free port, chosen by the OS
    assert not dist.is_initialized()
    try:
        assert tmesh.init_distributed("cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert not tmesh.init_distributed("cpu")    # already initialised
        mesh = tmesh.make_mesh(n_model=1)
        assert (mesh.dp_size, mesh.tp_size, mesh.dp_rank) == (1, 1, 0)
        assert mesh.dp_group is not None and tmesh.is_coordinator()
        with pytest.raises(ValueError, match="does not cover"):
            tmesh.make_mesh(n_model=2)
    finally:
        dist.destroy_process_group()
