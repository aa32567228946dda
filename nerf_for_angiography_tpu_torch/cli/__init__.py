"""The port's command-line entry points, with the flags, folder layout and
file names of the JAX package's ``cli/`` scripts (plus ``--device``):

    python -m nerf_for_angiography_tpu_torch.cli.datagen   # -> data/ct/*.csv
    python -m nerf_for_angiography_tpu_torch.cli.train     # -> cases/ct/runs/<time>/
    python -m nerf_for_angiography_tpu_torch.cli.evaluate  # -> df-metrics.csv, jsonData/
    python -m nerf_for_angiography_tpu_torch.cli.analyze   # -> analysis-plot.png

``cli/serve.py`` imports neither package and serves the port's jsonData as
it is. Each module's ``main(argv=None)`` runs it in-process.
"""
