"""The port's own copies of the framework-free host data code of
``nbest_asr_tpu/data/`` that it uses; each module names its original."""
