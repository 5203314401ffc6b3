"""The LM substrate's dense GQA transformer (port of ``repro.models`` for
the dense, full-attention architectures): prefill and decode steps over a
KV cache, with attention through kernel B6."""
