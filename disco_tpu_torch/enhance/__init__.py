"""Enhancement pipelines: two-step TANGO and the whole-clip chain."""
