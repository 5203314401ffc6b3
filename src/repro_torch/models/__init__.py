"""The LM substrate's GQA transformer, dense or mixture-of-experts, with
full or local attention (port of ``repro.models`` for the attention-mixer
architectures): prefill and decode steps over a KV cache, with attention
through kernel B6, and the training loss."""
