"""The port's offline tools, each run as ``python -m
nbest_asr_tpu_torch.tools.<name>`` with the flags, printed lines and
return codes of the JAX package's ``tools/<name>.py``."""
