"""One rank of a gloo process group on the CPU for the port's
multi-process tests (``test_torch_dp_tp.py``, ``test_torch_mesh.py``,
``test_torch_multiprocess.py``) -- not a test module.  It imports torch
and the port, never JAX.

``python torch_dist_worker.py MODE RANK WORLD DIR``: the rank joins the
group through a ``file://`` store in DIR (no port, so concurrent test
workers cannot collide), with one thread and a 120 s timeout, reads
``DIR/spec.json`` (and ``DIR/in.npz``), runs MODE and writes
``DIR/out<RANK>.npz`` / ``DIR/out<RANK>.json``:

- ``steps``: ``make_train_step`` over ``make_mesh(n_data, n_model,
  n_dcn)`` for the spec's steps, from the full parameter tree in
  ``in.npz``; writes the gathered parameters and each step's stats;
- ``embed``: the embeddings of ``in.npz``'s ids under tp, forward and
  the word table's gradient, gathered;
- ``cli``: ``cli.main(argv, device="cpu")`` (rank-specific extra flags
  allowed), recording each epoch's metrics and, after the run, the
  Trainer's gathered parameters.

``spawn`` (imported by the tests) starts the ranks and returns their
outputs.
"""

import json
import os
import subprocess
import sys
from datetime import timedelta

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
TIMEOUT_S = 120


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flat(v, key))
        else:
            out[key] = v
    return out


def unflat(d):
    tree = {}
    for key, v in d.items():
        node = tree
        *head, last = key.split("/")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return tree


def spawn(mode, world, tmp, spec, arrays=None):
    """Run ``world`` ranks of MODE in the directory ``tmp``; -> the
    ranks' (json, npz arrays) outputs, rank order."""
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    with open(os.path.join(tmp, "spec.json"), "w") as fp:
        json.dump(spec, fp)
    if arrays is not None:
        np.savez(os.path.join(tmp, "in.npz"), **arrays)
    logs = [open(os.path.join(tmp, f"log{r}"), "w") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, mode, str(r),
                               str(world), tmp], stdout=logs[r],
                              stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for r, rc in enumerate(rcs):
        if rc != 0:
            with open(os.path.join(tmp, f"log{r}")) as fp:
                raise AssertionError(f"{mode} rank {r}/{world} rc={rc}:\n"
                                     f"{fp.read()[-3000:]}")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"out{r}.json")) as fp:
            js = json.load(fp)
        with np.load(os.path.join(tmp, f"out{r}.npz")) as z:
            out.append((js, {k: z[k] for k in z.files}))
    return out


def _tensors(tree):
    import torch

    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _scalars(tree):
    return {k: {kk: float(vv) for kk, vv in v.items()}
            for k, v in tree.items()}


def run_steps(spec, arrays, rank):
    import torch

    from nbest_asr_tpu_torch.data.vocab import Memory
    from nbest_asr_tpu_torch.models.encoder import EncoderConfig
    from nbest_asr_tpu_torch.models.heads import hierarchy_device_arrays
    from nbest_asr_tpu_torch.models.model import ModelConfig
    from nbest_asr_tpu_torch.parallel.mesh import (gather_params,
                                                   make_mesh, shard_params)
    from nbest_asr_tpu_torch.parallel.train_step import (TrainState,
                                                         make_train_step)
    from nbest_asr_tpu_torch.train.losses import LossConfig
    from nbest_asr_tpu_torch.train.optimizer import (OptimizerConfig,
                                                     make_optimizer)

    memory = Memory.load(spec["memory"])
    enc = EncoderConfig(**spec["encoder"])
    cfg = ModelConfig(encoder=enc, n_top=memory.n_top,
                      n_bottom=memory.n_bottom)
    mesh = make_mesh(n_data=spec["n_data"], n_model=spec["n_model"],
                     n_dcn=spec["n_dcn"])
    params = shard_params(unflat(_tensors(
        {k[2:]: v for k, v in arrays.items() if k.startswith("p/")})), mesh)
    data = _tensors({k[2:]: v for k, v in arrays.items()
                     if k.startswith("d/")})
    opt = make_optimizer(OptimizerConfig(**spec["optimizer"]), params, mesh)
    step = make_train_step(cfg, LossConfig(add_l2_loss=spec["l2"]), opt,
                           hierarchy_device_arrays(memory.arrays()),
                           n_accum=spec["n_accum"],
                           dual_stream=spec["l2"], mesh=mesh)
    state = TrainState(params, opt.init(params), 0)
    gen = torch.Generator().manual_seed(7)
    stats = []
    for idx in arrays["idx"]:
        state, st = step(state, data, idx, gen)
        stats.append(_scalars(st))
    full = gather_params(state.params, mesh, enc.vocab_size)
    return {"stats": stats, "mesh": [mesh.dp_rank, mesh.tp_rank]}, \
        {k: v.numpy() for k, v in flat(full).items()}


def run_embed(spec, arrays, rank):
    import torch

    from nbest_asr_tpu_torch.models.encoder import EncoderConfig, _embed
    from nbest_asr_tpu_torch.parallel.mesh import (gather_params,
                                                   make_mesh, shard_params)

    cfg = EncoderConfig(**spec["encoder"])
    mesh = make_mesh(n_model=spec["n_model"])
    emb = shard_params({"encoder": {"embeddings": unflat(_tensors(
        {k[2:]: v for k, v in arrays.items() if k.startswith("e/")}))}},
        mesh)["encoder"]["embeddings"]
    for v in emb.values():
        v.requires_grad_(True)
    x = _embed({"embeddings": emb}, torch.from_numpy(arrays["ids"]),
               torch.from_numpy(arrays["types"]), cfg, mesh=mesh)
    x.backward(torch.from_numpy(arrays["dy"]))
    grads = gather_params({"encoder": {"embeddings": {"word": emb[
        "word"].grad}}}, mesh, cfg.vocab_size)
    return {}, {"x": x.detach().numpy(),
                "dword": grads["encoder"]["embeddings"]["word"].numpy(),
                "dtype": emb["type"].grad.numpy(),
                "dposition": emb["position"].grad.numpy()}


def run_cli(spec, arrays, rank):
    import torch

    from nbest_asr_tpu_torch import cli
    from nbest_asr_tpu_torch.parallel.mesh import gather_params
    from nbest_asr_tpu_torch.train import loop

    epochs, trainers = [], []
    if arrays is not None and any(k.startswith("h/") for k in arrays):
        head = unflat(_tensors({k[2:]: v for k, v in arrays.items()
                                if k.startswith("h/")}))
        loop.init_head_params = lambda *a, **k: dict(head)
    run_train, run_eval, train = (loop.Trainer.run_train_epoch,
                                  loop.Trainer.run_eval_epoch,
                                  loop.Trainer.train)

    def train_epoch(self):
        m = run_train(self)
        epochs.append(("train", metrics(m)))
        return m

    def eval_epoch(self, split, *a, **kw):
        m, info = run_eval(self, split, *a, **kw)
        epochs.append((split, metrics(m)))
        return m, info

    def record_train(self, *a, **kw):
        trainers.append(self)
        return train(self, *a, **kw)

    loop.Trainer.run_train_epoch = train_epoch
    loop.Trainer.run_eval_epoch = eval_epoch
    loop.Trainer.train = record_train
    argv = spec["argv"] + spec.get("rank_argv", {}).get(str(rank), [])
    rc = cli.main(argv, device="cpu")
    out = {}
    if trainers:
        tr = trainers[-1]
        full = gather_params(tr.state.params, tr.mesh,
                             tr.cfg.encoder.vocab_size)
        out = {k: v.numpy() for k, v in flat(full).items()}
    torch.distributed.barrier()
    return {"rc": rc, "epochs": epochs}, out


def metrics(m):
    return [m.mean_loss, m.precision, m.recall, m.f1, m.acc]


def main():
    mode, rank, world, tmp = sys.argv[1], int(sys.argv[2]), \
        int(sys.argv[3]), sys.argv[4]
    sys.path.insert(0, os.path.dirname(HERE))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(tmp, "store"),
        rank=rank, world_size=world, timeout=timedelta(seconds=TIMEOUT_S))
    try:
        with open(os.path.join(tmp, "spec.json")) as fp:
            spec = json.load(fp)
        arrays = None
        if os.path.exists(os.path.join(tmp, "in.npz")):
            with np.load(os.path.join(tmp, "in.npz")) as z:
                arrays = {k: z[k] for k in z.files}
        js, out = {"steps": run_steps, "embed": run_embed,
                   "cli": run_cli}[mode](spec, arrays, rank)
        np.savez(os.path.join(tmp, f"out{rank}.npz"), **out)
        with open(os.path.join(tmp, f"out{rank}.json"), "w") as fp:
            json.dump(js, fp)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
