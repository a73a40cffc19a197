"""The ten demos of ``demos/`` on the PyTorch port: the same arguments,
defaults and printed JSON keys, plus ``--device`` (the card unless
``cpu`` is given).  Each module has ``build(args, data, config, device)``
(the model before training) and ``main(argv=None)``, which prints as the
JAX demo does and returns its summary."""
