"""The port's own copies of the JAX package's framework-free data code
(``nbest_asr_tpu_torch/data/``, ``constants.py``) against the originals
on one synthetic DSTC2-shaped split: the same Memory arrays, the same
packed splits (Python and native packer), and the same packed micros and
length buckets."""

import numpy as np
import pytest

from nbest_asr_tpu import constants as j_const
from nbest_asr_tpu.data import bucketing as j_bucketing
from nbest_asr_tpu.data import etl as j_etl
from nbest_asr_tpu.data import input_builder as j_builder
from nbest_asr_tpu.data import native_loader as j_native
from nbest_asr_tpu.data import packing as j_packing
from nbest_asr_tpu.data import tokenizer as j_tok
from nbest_asr_tpu.data.dataset import RawSplit as JRawSplit
from nbest_asr_tpu_torch import constants as t_const
from nbest_asr_tpu_torch.data import bucketing as t_bucketing
from nbest_asr_tpu_torch.data import etl as t_etl
from nbest_asr_tpu_torch.data import input_builder as t_builder
from nbest_asr_tpu_torch.data import native_loader as t_native
from nbest_asr_tpu_torch.data import packing as t_packing
from nbest_asr_tpu_torch.data import tokenizer as t_tok
from nbest_asr_tpu_torch.data.dataset import RawSplit as TRawSplit

VALUES = {"food": ["chinese", "indian", "italian", "thai"],
          "area": ["north", "south", "centre"],
          "pricerange": ["cheap", "moderate", "expensive"]}


def _labels():
    out = [f"{act}-{slot}-{v}" for act in ("inform", "confirm", "deny")
           for slot, vals in VALUES.items() for v in vals]
    out += [f"request-{s}" for s in ("phone", "addr", "food")]
    return out + ["thankyou", "bye", "affirm", "negate"]


def _words():
    return [w for vals in VALUES.values() for w in vals] + (
        "i want a restaurant in the part of town serving food what is "
        "phone number address thank you good bye yes no please").split()


def _split(seed=0, n=40):
    """DSTC2-shaped raw rows: ``[CLS] [SYS] sys [USR] hyp [SEP] hyp``,
    transcripts, 0-3 labels, some out-of-vocabulary words."""
    rng = np.random.RandomState(seed)
    words, labels = _words() + ["zzz_oov"], _labels()
    asr, trans, lbls = [], [], []
    for _ in range(n):
        sys_w = list(rng.choice(words, size=rng.randint(1, 6)))
        hyps = [list(rng.choice(words, size=rng.randint(1, 9)))
                for _ in range(rng.randint(1, 5))]
        seq = ["[CLS]", "[SYS]", *sys_w, "[USR]"]
        for i, h in enumerate(hyps):
            seq += (["[SEP]"] if i else []) + h
        asr.append(seq)
        trans.append(["[CLS]", "[SYS]", *sys_w, "[USR]", *hyps[0]])
        lbls.append(list(rng.choice(labels, size=rng.randint(0, 4),
                                    replace=False)))
    return asr, trans, lbls


def _memories():
    args = (_words() * 2, _labels(), ["inform", "request", "offer"])
    return j_etl.build_memory(*args), t_etl.build_memory(*args)


def test_constants_and_memory_arrays():
    for name in ("PAD", "UNK", "CLS", "PAD_WORD", "SEP_MARK", "FIELD_SEP"):
        assert getattr(t_const, name) == getattr(j_const, name)
    jm, tm = _memories()
    assert tm.to_json() == jm.to_json()
    ja, ta = jm.arrays(), tm.arrays()
    for f in ("bottom2top", "membership", "is_multi_top",
              "group_last_bottom", "is_none_bottom", "singleton_onehot",
              "bottom2top_mat"):
        np.testing.assert_array_equal(getattr(ta, f), getattr(ja, f))
    assert j_etl.split_label("inform-food-thai") == \
        t_etl.split_label("inform-food-thai")


def _assert_packed_equal(got, want):
    for f in ("input_ids", "segment_ids", "attn_mask", "trans_input_ids",
              "trans_segment_ids", "trans_attn_mask", "labels"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.max_len == want.max_len
    assert got.raw_labels == want.raw_labels


@pytest.mark.parametrize("layout", ["default", "tod", "no_system_act"])
def test_pack_split_python(layout):
    jm, tm = _memories()
    asr, trans, lbls = _split()
    want = j_builder.pack_split(JRawSplit(asr, trans, lbls),
                                j_tok.WordVocabTokenizer(jm), jm,
                                layout=layout)
    got = t_builder.pack_split(TRawSplit(asr, trans, lbls),
                               t_tok.WordVocabTokenizer(tm), tm,
                               layout=layout)
    _assert_packed_equal(got, want)


def test_pack_lines_native():
    if not (t_native.native_available() and j_native.native_available()):
        pytest.skip("no C++ toolchain for the native packer")
    jm, tm = _memories()
    asr, trans, lbls = _split(seed=1)
    ttok = t_tok.WordVocabTokenizer(tm)
    assert t_native.native_supported(ttok)
    want = j_native.NativePacker(jm, j_tok.WordVocabTokenizer(jm)) \
        .pack_lines(asr, trans, lbls, max_len=64)
    got = t_native.NativePacker(tm, ttok).pack_lines(asr, trans, lbls,
                                                     max_len=64)
    _assert_packed_equal(got, want)
    py = t_builder.pack_split(TRawSplit(asr, trans, lbls), ttok, tm,
                              max_len=64)
    np.testing.assert_array_equal(got.input_ids, py.input_ids)


def test_packed_micros_and_buckets():
    jm, tm = _memories()
    asr, trans, lbls = _split(seed=2, n=60)
    p = t_builder.pack_split(TRawSplit(asr, trans, lbls),
                             t_tok.WordVocabTokenizer(tm), tm)
    data = {k: getattr(p, k) for k in (
        "input_ids", "segment_ids", "attn_mask", "trans_input_ids",
        "trans_segment_ids", "trans_attn_mask", "labels")}
    want, wbins = j_packing.pack_train_data(data, capacity=48, max_segs=3)
    got, gbins = t_packing.pack_train_data(data, capacity=48, max_segs=3)
    assert gbins == wbins and set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    lens = t_bucketing.row_lengths(data)
    np.testing.assert_array_equal(lens, j_bucketing.row_lengths(data))
    jb = j_bucketing.bucket_assignment(lens, [16, 24, 32], 64)
    tb = t_bucketing.bucket_assignment(lens, [16, 24, 32], 64)
    assert [b for b, _ in tb] == [b for b, _ in jb]
    for (blen, jr), (_, tr) in zip(jb, tb):
        np.testing.assert_array_equal(tr, jr)
        js = j_bucketing.slice_rows(data, jr, blen)
        ts = t_bucketing.slice_rows(data, tr, blen)
        for k in js:
            np.testing.assert_array_equal(ts[k], js[k])
