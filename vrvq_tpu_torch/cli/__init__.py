"""Command-line entry points: ``python -m vrvq_tpu_torch.cli.train`` and
``python -m vrvq_tpu_torch.cli.inference``, each driven by a YAML file of
``conf/`` (``--args.load``) and ``--key value`` overrides."""
