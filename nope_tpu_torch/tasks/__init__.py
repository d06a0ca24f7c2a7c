"""The pose-conditional task and its symmetry-aware metrics."""
