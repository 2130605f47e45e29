"""Training targets: anchor (RPN) and proposal (head) samplers."""
