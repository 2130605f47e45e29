"""Device choice and the flax weight bridge."""
