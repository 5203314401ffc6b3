"""The synthetic LM token pipeline (port of ``repro.data``)."""
