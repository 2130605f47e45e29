"""Two-pass predict."""
