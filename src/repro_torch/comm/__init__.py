"""Communication between agents: lossy channels."""
