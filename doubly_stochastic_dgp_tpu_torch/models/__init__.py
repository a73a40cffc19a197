"""Deep GP models, layers, mean functions and the serving cache."""
