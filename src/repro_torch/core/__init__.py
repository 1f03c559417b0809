"""NetES algorithm core: topologies, their representations, ES utilities."""
