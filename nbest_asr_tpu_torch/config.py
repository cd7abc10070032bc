"""Run configuration and CLI flags -- a copy of ``nbest_asr_tpu/config.py``
(``RunOptions`` :24, its properties :172-198, ``parse_arguments`` :200)
with the same flags and defaults, so that one command line drives either
package.

Every flag falls into one of three groups on the port:

- **Honoured**, as the JAX package honours it.  ``--deviceId N`` picks
  ``cuda:N`` (-1, the default, is ``cuda:0``); the CPU is reached only by a
  caller passing ``device="cpu"`` to ``cli.main``.  The kernel flags
  (``--use_flash_attention``, ``--use_fused_ffn``, ``--use_fused_attn``
  and their ``--no_*`` twins) resolve "auto" to the hand-written kernels
  on CUDA, as JAX's resolve to its Pallas kernels on a TPU; the
  ``--int8_train*`` flags resolve "auto" to off on CUDA (the int8 step is
  slower than the bf16 one on the H100, PERF.md) and are honoured when
  given.  The reference's vestigial flags (``--emb_size``,
  ``--hidden_size``, ``--d_k``, ``--d_v``, ``--score_util``,
  ``--sent_repr``, ``--cls_type``, ``--bert_model_name``,
  ``--with_system_act``, ``--init_type``, ``--init_range``) reach the
  experiment directory's name or nothing, exactly as in the JAX package.
  ``--pre_trained_model bert|roberta|xlm-roberta`` (a directory under
  ``$NBEST_HF_LOCAL`` named as ``HF_NAMES`` says) and
  ``--tod_pre_trained_model DIR`` fine-tune from a local checkpoint
  directory, read without ``transformers`` (``models/hf_convert.py``);
  a BERT-family directory's tokenizer is the port's ``WordPieceTokenizer``,
  RoBERTa's and XLM-R's need ``transformers`` (``data/tokenizer.py``).
  ``--require_pretrained`` turns a checkpoint or tokenizer that fails to
  load into an error (return code 2) instead of JAX's warning and
  from-scratch run.
  ``--n_model_parallel T`` and ``--data_mode index|direct`` run the
  process mesh of ``parallel/mesh.py`` under torchrun (``cli.py``): T
  must divide the world size.
- **Refused** (``unsupported`` names them; the CLI returns 2 with the
  message), each until the ROADMAP queue-1 item that brings it:
  ``--profile_dir`` (item 6, the tools), and ``--remat``, which the port
  neither maps to activation checkpointing nor ignores (queued beside
  item 1's "map or refuse").
- **Accepted and inert**, because the flag only steers TPU machinery:
  ``--prng_impl`` picks JAX's PRNG for dropout masks; the port's masks
  are Philox, keyed on a seed drawn from a ``torch.Generator``.
  ``--steps_per_call K`` groups JAX's epoch plan into chains of K steps
  compiled as one call; the port builds the same plan with the same
  shuffle draws and runs a chain as its K steps in order.
  ``--no_native_loader``: the CLI packs with the Python packer, JAX's own
  oracle and fallback (``nbest_asr_tpu/cli.py:34-44``), until the port's
  ``pack_file_native`` lands (queue 1 item 6).
"""

from __future__ import annotations

import argparse
import json
from dataclasses import dataclass, field
from typing import List, Optional


@dataclass
class RunOptions:
    # ------------- model structure (ref :43-55) ----------------------- #
    emb_size: int = 256
    hidden_size: int = 512
    max_seq_len: Optional[int] = None
    n_layers: int = 6
    n_head: int = 4
    d_k: int = 64
    d_v: int = 64
    score_util: str = "pp"
    sent_repr: str = "bin_sa_cls"
    cls_type: str = "stc"

    # ------------- data & vocab (ref :57-63) -------------------------- #
    dataset: str = "dstc2"
    dataroot: str = ""
    train_file: str = "train"
    valid_file: str = "valid"
    test_file: str = "test"
    ontology_path: Optional[str] = None

    # ------------- pretrained model (ref :66-68, :100-101) ------------ #
    bert_model_name: str = "bert-base-uncased"
    fix_bert_model: bool = False
    pre_trained_model: Optional[str] = None
    tod_pre_trained_model: Optional[str] = None
    require_pretrained: bool = False

    # ------------- training & testing (ref :71-86) -------------------- #
    testing: bool = False
    deviceId: int = -1
    random_seed: int = 999
    l2: float = 0.0
    dropout: float = 0.0
    bert_dropout: float = 0.1
    batchSize: int = 16
    max_norm: float = 5.0
    max_epoch: int = 50
    experiment: str = "exp"
    optim_choice: str = "bertadam"
    lr: float = 5e-4
    bert_lr: float = 1e-5
    warmup_proportion: float = 0.1
    init_type: str = "uf"
    init_range: float = 0.2

    # ------------- semantics flags (ref :89-109) ---------------------- #
    with_system_act: bool = False
    coverage: Optional[float] = None
    add_l2_loss: bool = False
    without_system_act: bool = False
    add_segment_ids: bool = False

    # ------------- the JAX package's additions ------------------------ #
    compute_dtype: str = "float32"
    prng_impl: str = "rbg"
    use_flash_attention: "bool | None" = None
    use_fused_ffn: "bool | None" = None
    use_fused_attn: "bool | None" = None
    int8_train: "bool | None" = None
    int8_train_attn: "bool | None" = None
    int8_train_bwd: "bool | None" = None
    flash_min_seq: int = 160
    remat: bool = False
    n_model_parallel: int = 1
    len_multiple: int = 8
    length_buckets: str = ""
    memory_file: str = "memory.json"
    native_loader: bool = True
    eval_batch: Optional[int] = None
    steps_per_call: int = 1
    token_budget: Optional[int] = None
    pack_examples: bool = False
    pack_capacity: int = 256
    pack_max_segs: int = 8
    data_mode: str = "index"
    checkpoint_every: int = 0
    resume: Optional[str] = None
    profile_dir: Optional[str] = None
    eval_every: int = 1
    eval_artifacts: str = "full"
    save_best: str = "ckpt"

    # ------------- resolved at setup ---------------------------------- #
    ontology: Optional[dict] = field(default=None, repr=False)
    exp_dir: str = ""

    @property
    def n_accum_steps(self) -> int:
        # parity: `n_best_asr_bert.py:522`
        return 4 if self.n_layers == 12 else 1

    @property
    def micro_batch(self) -> int:
        # parity: dataloader batch = batchSize / n_accum (ref :527)
        return max(1, int(self.batchSize / self.n_accum_steps))

    @property
    def layout(self) -> str:
        if self.tod_pre_trained_model:
            return "tod"
        if self.without_system_act:
            return "no_system_act"
        return "default"

    def resolve(self) -> "RunOptions":
        if self.ontology_path:
            with open(self.ontology_path) as fp:
                self.ontology = json.load(fp)
        if not self.exp_dir:
            from .utils.exp_dir import get_exp_dir

            self.exp_dir = get_exp_dir(self)
        return self


def unsupported(opt: RunOptions) -> List[str]:
    """The refused flags that ``opt`` sets, each with the ROADMAP item
    that brings it (module docstring); empty when the port runs ``opt``."""
    out = []
    if opt.profile_dir:
        out.append("--profile_dir is not supported by the port yet: the "
                   "profiling tools come with ROADMAP queue 1 item 6")
    if opt.remat:
        out.append("--remat is not supported by the port: activation "
                   "checkpointing is queued (ROADMAP queue 1 item 1, "
                   "'map or refuse')")
    return out


def parse_arguments(argv=None) -> RunOptions:
    d = RunOptions()
    p = argparse.ArgumentParser(
        description="nbest_asr_tpu_torch trainer (reference-compatible CLI)")

    # model structure
    p.add_argument("--emb_size", type=int, default=d.emb_size)
    p.add_argument("--hidden_size", type=int, default=d.hidden_size)
    p.add_argument("--max_seq_len", type=int, default=None)
    p.add_argument("--n_layers", type=int, default=d.n_layers)
    p.add_argument("--n_head", type=int, default=d.n_head)
    p.add_argument("--d_k", type=int, default=d.d_k)
    p.add_argument("--d_v", type=int, default=d.d_v)
    p.add_argument("--score_util", default=d.score_util,
                   choices=["none", "np", "pp", "mul"])
    p.add_argument("--sent_repr", default=d.sent_repr)
    p.add_argument("--cls_type", default=d.cls_type,
                   choices=["nc", "tf_hd", "stc"])

    # data & vocab
    p.add_argument("--dataset", required=True)
    p.add_argument("--dataroot", required=True)
    p.add_argument("--train_file", default=d.train_file)
    p.add_argument("--valid_file", default=d.valid_file)
    p.add_argument("--test_file", default=d.test_file)
    p.add_argument("--ontology_path", default=None)

    # pretrained model
    p.add_argument("--bert_model_name", default=d.bert_model_name)
    p.add_argument("--fix_bert_model", action="store_true")
    p.add_argument("--pre_trained_model", default=None)
    p.add_argument("--tod_pre_trained_model", default=None)
    p.add_argument("--require_pretrained", action="store_true")

    # training & testing
    p.add_argument("--testing", action="store_true")
    p.add_argument("--deviceId", type=int, default=-1)
    p.add_argument("--random_seed", type=int, default=d.random_seed)
    p.add_argument("--l2", type=float, default=d.l2)
    p.add_argument("--dropout", type=float, default=d.dropout)
    p.add_argument("--bert_dropout", type=float, default=d.bert_dropout)
    p.add_argument("--batchSize", type=int, default=d.batchSize)
    p.add_argument("--max_norm", type=float, default=d.max_norm)
    p.add_argument("--max_epoch", type=int, default=d.max_epoch)
    p.add_argument("--experiment", default=d.experiment)
    p.add_argument("--optim_choice", default=d.optim_choice,
                   choices=["adam", "adamw", "bertadam"])
    p.add_argument("--lr", type=float, default=d.lr)
    p.add_argument("--bert_lr", type=float, default=d.bert_lr)
    p.add_argument("--warmup_proportion", type=float,
                   default=d.warmup_proportion)
    p.add_argument("--init_type", default=d.init_type,
                   choices=["uf", "xuf", "normal"])
    p.add_argument("--init_range", type=float, default=d.init_range)

    # semantics flags
    p.add_argument("--with_system_act", action="store_true")
    p.add_argument("--coverage", type=float, default=None)
    p.add_argument("--add_l2_loss", action="store_true")
    p.add_argument("--without_system_act", action="store_true")
    p.add_argument("--add_segment_ids", action="store_true")

    # the JAX package's additions
    p.add_argument("--compute_dtype", default=d.compute_dtype,
                   choices=["float32", "bfloat16"])
    p.add_argument("--prng_impl", default=d.prng_impl,
                   choices=["rbg", "unsafe_rbg", "threefry2x32"],
                   help="accepted and inert: the port's dropout is Philox")
    p.add_argument("--use_flash_attention", action="store_true",
                   default=None, help="force the flash attention kernels "
                   "on the training path (default: auto -- on for CUDA)")
    p.add_argument("--no_flash_attention", dest="use_flash_attention",
                   action="store_false", help="force the plain attention "
                   "path everywhere")
    p.add_argument("--use_fused_ffn", action="store_true", default=None,
                   help="force the FFN block's kernels (default: auto -- "
                   "on for CUDA)")
    p.add_argument("--no_fused_ffn", dest="use_fused_ffn",
                   action="store_false", help="force the plain FFN path")
    p.add_argument("--use_fused_attn", dest="use_fused_attn",
                   action="store_true", default=None,
                   help="force the attention block's kernels (default: "
                   "auto -- on for CUDA)")
    p.add_argument("--no_fused_attn", dest="use_fused_attn",
                   action="store_false",
                   help="force the plain attention path")
    p.add_argument("--int8_train", action="store_true", default=None,
                   help="int8 forward GEMMs in the training FFN block "
                   "(default: auto -- off on CUDA)")
    p.add_argument("--no_int8_train", dest="int8_train",
                   action="store_false")
    p.add_argument("--int8_train_attn", action="store_true",
                   default=None,
                   help="int8 QKV and out-proj forward GEMMs in the "
                   "training attention block (default: auto -- off on "
                   "CUDA)")
    p.add_argument("--no_int8_train_attn", dest="int8_train_attn",
                   action="store_false")
    p.add_argument("--int8_train_bwd", action="store_true",
                   default=None,
                   help="int8 dgrads in the int8 blocks' backwards "
                   "(default: auto -- off on CUDA)")
    p.add_argument("--no_int8_train_bwd", dest="int8_train_bwd",
                   action="store_false")
    p.add_argument("--flash_min_seq", type=int, default=d.flash_min_seq,
                   help="flash-attention routing threshold (bucketed "
                   "seq >= this trains on the flash kernels)")
    p.add_argument("--remat", action="store_true",
                   help="refused by the port (ROADMAP)")
    p.add_argument("--n_model_parallel", type=int, default=1)
    p.add_argument("--len_multiple", type=int, default=d.len_multiple)
    p.add_argument("--length_buckets", default=d.length_buckets)
    p.add_argument("--memory_file", default=d.memory_file)
    p.add_argument("--no_native_loader", dest="native_loader",
                   action="store_false")
    p.set_defaults(native_loader=True)
    p.add_argument("--eval_batch", type=int, default=None)
    p.add_argument("--steps_per_call", type=int, default=d.steps_per_call)
    p.add_argument("--token_budget", type=int, default=None)
    p.add_argument("--pack_examples", action="store_true",
                   help="pack several train utterances per fixed-shape "
                   "row (block-diagonal segment attention, per-segment "
                   "positions/CLS; per-utterance math unchanged)")
    p.add_argument("--pack_capacity", type=int, default=d.pack_capacity,
                   help="packed row length (widened if an utterance is "
                   "longer; never truncates)")
    p.add_argument("--pack_max_segs", type=int, default=d.pack_max_segs,
                   help="max utterances per packed row")
    p.add_argument("--data_mode", default=d.data_mode,
                   choices=["index", "direct"],
                   help="direct = per-process data sharding "
                   "(parallel/process_data.py); index = every rank holds "
                   "the split (default)")
    p.add_argument("--checkpoint_every", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--eval_every", type=int, default=d.eval_every,
                   help="evaluate valid/test every N epochs (always on "
                   "the final epoch); reference behavior is 1")
    p.add_argument("--eval_artifacts", default=d.eval_artifacts,
                   choices=["full", "none"],
                   help="'none' skips the per-epoch dumps/CSVs/"
                   "per-label reports (metrics and best.json are "
                   "unchanged) -- for seed sweeps")
    p.add_argument("--save_best", default=d.save_best,
                   choices=["ckpt", "none"],
                   help="'none' tracks/logs the best epoch without "
                   "writing the checkpoint (--testing needs 'ckpt')")

    args = p.parse_args(argv)
    opt = RunOptions(**vars(args))
    return opt.resolve()
