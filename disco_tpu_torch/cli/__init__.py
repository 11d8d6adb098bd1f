"""Command-line entry points of the port, one module per JAX package CLI
(``disco_tpu/cli/``), each a thin argparse layer over the port's functions
with the JAX parser's flags plus ``--device`` (``cuda`` by default, ``cpu``
for the plain versions; without a CUDA device a command raises, it never
falls back to the CPU):

==========================  =============================================
``disco-torch-gen``         gen_disco (rooms, RIRs, convolved sources)
``disco-torch-gen-meetit``  gen_meetit (MEETIT meeting rooms)
``disco-torch-mix``         mix (PostGenerator: mixtures, STFTs, masks)
``disco-torch-get-z``       get_z (step-1 z export)
``disco-torch-lists``       lists (training input lists)
``disco-torch-train``       train (CRNN training)
``disco-torch-tango``       tango (enhancement, one clip or a corpus)
``disco-torch-aggregate``   aggregate (mean ± 95% CI of the OIM pickles)
``disco-torch-scenes``      scenes (the batched scenario factory)
``disco-torch-serve``       serve (the online enhancement service)
``disco-torch-obs``         obs (report, trace, top, slo)
``disco-torch-milestones``  bench_milestones (the milestone harnesses)
``disco-torch-download``    download (Freesound fetch, csv cleaning, the
                            LibriSpeech/Zenodo URLs; host only, no
                            ``--device``)
==========================  =============================================

Each module also runs as ``python -m disco_tpu_torch.cli.<module>``.  Every
corpus-scale CLI takes ``--rirs start count`` and is idempotent, so job
arrays shard a corpus as the reference's do.
"""
# the modules are not imported here: ``python -m disco_tpu_torch.cli.<module>``
# would otherwise find its module loaded before it runs
__all__ = ["aggregate", "bench_milestones", "download", "gen_disco", "gen_meetit", "get_z",
           "lists", "mix", "obs", "scenes", "serve", "tango", "train"]
