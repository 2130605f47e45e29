"""The train step: losses, optimizer state, the step itself."""
