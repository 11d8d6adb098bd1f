"""Enhancement pipelines: two-step TANGO, the whole-clip chain, streaming,
the CRNN mask stage and the corpus driver."""
