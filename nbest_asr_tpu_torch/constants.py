"""Special-token constants shared by the data pipeline -- the port's
copy of ``nbest_asr_tpu/constants.py``.

Parity: reference `utils/Constants.py:1-12` (PAD=0, UNK=1, BOS=2, EOS=3,
CLS=4 and their word forms).  These ids index the *word-level* vocab built by
the DSTC2 ETL, not the subword tokenizer vocab.
"""

PAD = 0
UNK = 1
BOS = 2
EOS = 3
CLS = 4

PAD_WORD = "<pad>"
UNK_WORD = "<unk>"
BOS_WORD = "<s>"
EOS_WORD = "</s>"
CLS_WORD = "<cls>"

# Markers used in the serialized line format (reference
# `helpers/process_dstc2_with_SEP.py:219-227`).
CLS_MARK = "[CLS]"
SYS_MARK = "[SYS]"
USR_MARK = "[USR]"
SEP_MARK = "[SEP]"

# Field separator of the processed shards
# (`helpers/process_dstc2_with_SEP.py:245`).
FIELD_SEP = "\t<=>\t"
LABEL_SEP = ";"
