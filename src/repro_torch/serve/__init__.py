"""Serving: the multi-session SpaRW render serving engine
(:mod:`repro_torch.serve.render_engine`) and its admission policies
(:mod:`repro_torch.serve.policies`). The LM serving engine is not ported."""
