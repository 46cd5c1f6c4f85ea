"""The reference's example entry points on the port.

One module per example of the repository's ``examples/`` folder:
``quickstart``, ``serve_quantized``, ``train_lm`` and ``multipod_dryrun``.
Each runs as ``python -m repro_torch.examples.<name>``, takes the
reference example's flags plus ``--device`` (default ``cuda``) and prints
the reference's lines under the same labels.  Importing a module touches
no device and parses no arguments: each is split into functions that take
their inputs, and its ``main`` draws seeded inputs from an explicit
``torch.Generator``.
"""
