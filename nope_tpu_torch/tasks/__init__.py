"""The pose-conditional task (inference path)."""
