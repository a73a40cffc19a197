"""The systems under test as the benchmark builds them, one module a model
family (a configuration's ``system``), each with ``make_inputs(config,
seed, device)`` (everything the benchmark makes from the seed, which the
reference takes too), ``build_model(config, inputs, device)`` (the port's
model, through its public entry points) and ``trainable_leaves(model)``
({the reference's name: parameter}, in the optimizer's order)."""
