"""Bottom-up backbones and the FPN neck."""
