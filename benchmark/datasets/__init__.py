"""Data sets made from the run's seed, one module a ``data.kind`` of a
configuration, each with ``make(config, seed, device) -> {"X", "Y", "Xs",
"Ys"}``: training and test rows on ``device``, X in float32."""
