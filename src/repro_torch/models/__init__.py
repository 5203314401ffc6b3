"""The LM substrate: a stack of GQA attention layers (dense or
mixture-of-experts FFN, full or local attention) and recurrent mixers
(Mamba, mLSTM, sLSTM) (port of ``repro.models`` without the encoder and
image-prefix frontends): prefill and decode steps over per-layer caches,
with attention through kernel B6, and the training loss."""
