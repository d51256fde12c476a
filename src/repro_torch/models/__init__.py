"""The dense-LM scaffold (port of ``repro.models``): decoder-only LMs
whose layers are all attention + dense FFN."""
