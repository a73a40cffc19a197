"""Plain reference of the benchmark: torch and numpy only."""
