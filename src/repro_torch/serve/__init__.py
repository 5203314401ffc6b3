"""Serving: the multi-session SpaRW render serving engine
(:mod:`repro_torch.serve.render_engine`) and its admission policies
(:mod:`repro_torch.serve.policies`), and the LM serving engine
(:mod:`repro_torch.serve.engine`: :class:`Request`, :class:`ServeEngine`)."""
from repro_torch.serve.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
