"""Command-line entry points: train, evaluate, the demo and the viewer."""
