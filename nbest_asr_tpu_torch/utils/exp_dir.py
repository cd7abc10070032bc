"""Deterministic experiment-directory naming -- a copy of
``nbest_asr_tpu/utils/exp_dir.py`` (``get_exp_dir`` :14).

Parity: `utils/util.py:20-55` (`get_exp_dir_bert`) -- the hyperparameters
are encoded into the directory name so runs are self-describing:
``exp/data_<ds>/nl_..__nh_..__dk_..__dv_..__bs_..__dp_..__opt_..__mn_..__
me_..__seed_..__score_..__repr_..__cls_..``.
"""

from __future__ import annotations

import os


def get_exp_dir(opt) -> str:
    parts = [
        f"nl_{opt.n_layers}",
        f"nh_{opt.n_head}",
        f"dk_{opt.d_k}",
        f"dv_{opt.d_v}",
        f"bs_{opt.batchSize}",
        f"dp_{opt.dropout}_{opt.bert_dropout}",
        f"opt_{opt.optim_choice}_{opt.warmup_proportion}_"
        f"{opt.lr}_{opt.bert_lr}",
        f"mn_{opt.max_norm}",
        f"me_{opt.max_epoch}",
        f"seed_{opt.random_seed}",
        f"score_{opt.score_util}",
        f"repr_{opt.sent_repr}",
        f"cls_{opt.cls_type}",
    ]
    # knobs that change training dynamics are appended only when
    # non-default, so reference-parity runs keep reference-parity names
    # (the full config always lands in exp_dir/config.json)
    if getattr(opt, "flash_min_seq", 160) != 160:
        parts.append(f"fms_{opt.flash_min_seq}")
    if getattr(opt, "eval_every", 1) != 1:
        # changes which epochs can be selected as best
        parts.append(f"ee_{opt.eval_every}")
    return os.path.join(opt.experiment, f"data_{opt.dataset}",
                        "__".join(parts))
